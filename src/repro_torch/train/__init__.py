"""The LM training step (`step`): chunked cross-entropy, MoE aux and
z-loss, per-block remat, microbatches, AdamW."""
