"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base] 40L, d_model 6144, 48 heads / 8 KV,
expert d_ff 10752, vocab 100352, 16 experts top-4 (36B active / 132B total).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,                 # per-expert FFN width
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=5e5,
))
