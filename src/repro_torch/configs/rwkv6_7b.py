"""rwkv6-7b [ssm] — "Finch", attention-free, data-dependent decay.

[arXiv:2404.05892] RWKV-6 World 7B: 32L, d_model 4096 (64 heads × 64),
channel-mix d_ff 14336, vocab 65536.  O(1)/token state -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,               # RWKV6 head size 64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    mixer="rwkv",
    rope_style="none",
    pos_style="none",
))
