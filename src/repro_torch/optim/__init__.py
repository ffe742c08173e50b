"""AdamW with the reference's cosine schedule (`adamw`), on dicts of
tensors."""
