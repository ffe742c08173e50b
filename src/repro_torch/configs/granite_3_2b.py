"""granite-3-2b [dense] — GQA kv=8.

[hf:ibm-granite/granite-3.0-2b-base] 40L, d_model 2048, 32 heads / 8 KV,
d_ff 8192, vocab 49155.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=1e4,
))
