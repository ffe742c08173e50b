"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284] 48L, d_model 1536, 24 heads (kv=24 -> MHA), d_ff 6144,
vocab 2048 (EnCodec codebook).  The EnCodec conv codec frontend is STUBBED
per the assignment carve-out: input_specs() provides precomputed frame
embeddings; this model is the decoder transformer that consumes them.
MusicGen uses sinusoidal positions (no RoPE).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pos_style="sinusoidal",
    rope_style="none",
    input_mode="embeddings",
))
