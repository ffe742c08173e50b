"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.

[arXiv:2403.19887 / Jamba-1.5] 72L, d_model 8192, 64 heads / 8 KV,
d_ff 24576, vocab 65536, MoE 16 experts top-2 on alternate layers
(94B active / 398B total), one attention layer per 8-layer block,
Mamba d_state 16.  Sub-quadratic per token -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mixer="hybrid",
    attn_period=8,              # 1 attention : 7 mamba
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,                # MoE on alternate layers (Jamba design)
    mamba_d_state=16,
    mamba_expand=2,
))
