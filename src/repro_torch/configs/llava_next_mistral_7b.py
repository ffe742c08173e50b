"""llava-next-mistral-7b [vlm] — anyres tiling over a Mistral-7B backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] Backbone: 32L, d_model 4096,
32 heads / 8 KV, d_ff 14336, vocab 32000, sliding-window 4096 (Mistral).
The SigLIP/CLIP vision tower + anyres tile projector are STUBBED per the
assignment carve-out: input_specs() provides precomputed patch+text
embeddings (B, S, d_model); this is the language decoder that consumes
them.  Sliding-window attention makes it long_500k-eligible.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,        # Mistral SWA
    input_mode="embeddings",
    rope_theta=1e6,
))
