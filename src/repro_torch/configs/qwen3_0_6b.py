"""qwen3-0.6b [dense] — qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B family card] 28L, d_model 1024, 16 heads / 8 KV,
explicit head_dim 128, d_ff 3072, vocab 151936, RMSNorm on q/k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,               # Qwen3 decouples head_dim from d_model/heads
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
))
