"""chatglm3-6b [dense] — RoPE 2d (rotary on half the head dims), GQA kv=2.

[arXiv:2406.12793] ChatGLM family: 28L, d_model 4096, 32 heads with
2 KV (multi-query-ish GQA), d_ff 13696, vocab 65024.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",          # GLM 2d-RoPE: rotary applied to half of head_dim
    rope_theta=1e4,
))
