"""olmoe-1b-7b [moe] — 64 experts, top-8.

[arXiv:2409.02060] 16L, d_model 2048, 16 heads (kv=16 -> MHA),
expert d_ff 1024, vocab 50304, 64 experts top-8 (1B active / 7B total).
OLMoE uses qk-norm.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                  # per-expert FFN width
    vocab_size=50304,
    num_experts=64,
    num_experts_per_tok=8,
    qk_norm=True,
))
