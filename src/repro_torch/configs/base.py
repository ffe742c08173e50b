"""Architecture config schema + registry + the four assigned input shapes,
ported from `repro.configs.base` field for field.

Every architecture file in this package instantiates `ArchConfig` with the
exact figures from its source paper/model card (cited in each file), the
same figures as the reference's.  `reduced()` yields the same 2-layer
smoke variant (d_model <= 512, <= 4 experts, small vocab, float32), used
by the port's LM tests and by `chip_smoke.py` phase 11.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# The four assigned input shapes (assignment block).
INPUT_SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # attention flavor
    rope_style: str = "full"     # full | half (2d-RoPE: rotary on half dims) | none
    pos_style: str = "rope"      # rope | sinusoidal (musicgen)
    qk_norm: bool = False        # qwen3
    rope_theta: float = 1e4
    sliding_window: int = 0      # 0 = full attention (mistral/llava: 4096)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1           # apply MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25

    # layer mixture
    mixer: str = "attn"          # attn | rwkv | hybrid (jamba)
    attn_period: int = 0         # hybrid: one attn layer per `attn_period` layers
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4

    # io
    input_mode: str = "tokens"   # tokens | embeddings (audio/vlm frontend stub)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def block_pattern(self) -> tuple[tuple[str, str], ...]:
        """((mixer, ffn), ...) for one scanned block; model = num_blocks × pattern."""
        if self.mixer == "hybrid":
            p = self.attn_period
            pat = []
            for i in range(p):
                mix = "attn" if i == p - 1 else "mamba"
                ffn = "moe" if (self.num_experts and i % self.moe_every == 1) else "dense"
                pat.append((mix, ffn))
            return tuple(pat)
        if self.mixer == "rwkv":
            return (("rwkv", "channelmix"),)
        ffn = "moe" if self.num_experts else "dense"
        return (("attn", ffn),)

    @property
    def num_blocks(self) -> int:
        p = len(self.block_pattern)
        assert self.num_layers % p == 0, (self.name, self.num_layers, p)
        return self.num_layers // p

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic attention available (for long_500k eligibility)."""
        return self.mixer in ("rwkv", "hybrid") or self.sliding_window > 0

    def reduced(self) -> "ArchConfig":
        """2-layer smoke variant: d_model<=512, <=4 experts, small vocab."""
        p = len(self.block_pattern)
        layers = p if p >= 2 else 2
        d = min(self.d_model, 256)
        heads = 4
        kv = min(self.num_kv_heads, heads)
        kv = next(k for k in range(kv, 0, -1) if heads % k == 0)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=64, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32")


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in ("chatglm3_6b", "qwen3_0_6b", "granite_3_2b", "rwkv6_7b",
                "jamba_1_5_large", "musicgen_medium", "llama3_8b",
                "llama3_8b_sw", "olmoe_1b_7b", "dbrx_132b",
                "llava_next_mistral_7b"):
        importlib.import_module(f"repro_torch.configs.{mod}")
