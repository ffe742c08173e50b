"""Transformer building blocks: RMSNorm, RoPE (full/half), GQA attention
(qk-norm, sliding-window, decode-with-cache), SwiGLU MLP.

Ported from `repro.models.layers` as plain torch ops on tensors, with the
reference's parameter dicts and weight layouts: W_q is (d_model, H·hd)
and every product is `x @ w` over the same axis as the reference's
`einsum`.  The reference's sharding constraints (`shd.shard`) are the
identity on one device and are dropped.

Init functions draw from an explicit `torch.Generator` on its device and
return tensors with a leading `lead` shape (the stacked block axis), with
the reference's shapes and scales; `gen=None` builds the same tree on the
meta device (shapes and dtypes only).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _dev(gen):
    return gen.device if gen is not None else torch.device("meta")


def normal(gen, shape, scale, dtype) -> torch.Tensor:
    """N(0, 1) · scale, drawn in float32 on the generator's device and cast
    once: a bfloat16 tree is the float32 tree rounded."""
    x = torch.randn(tuple(shape), generator=gen, device=_dev(gen),
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def uniform(gen, shape, lo=0.0, hi=1.0) -> torch.Tensor:
    x = torch.rand(tuple(shape), generator=gen, device=_dev(gen),
                   dtype=torch.float32)
    return x * (hi - lo) + lo


def full(gen, shape, value, dtype) -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=_dev(gen))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """(sin, cos) tables for `dim` rotary dims at given positions (...,)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs                  # (..., dim/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               style: str) -> torch.Tensor:
    """x: (B, S, H, hd).  style: full | half (GLM 2d-RoPE) | none.

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) of the first
    `rot` dims, as the reference does (not the rotate-half layout)."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "full" else hd // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    sin_ = sin[:, :, None, :rot // 2].to(x.dtype)
    cos_ = cos[:, :, None, :rot // 2].to(x.dtype)
    o1 = x1 * cos_ - x2 * sin_
    o2 = x2 * cos_ + x1 * sin_
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def sinusoidal_emb(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, lead=()):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(gen, (*lead, d, h * hd), s, dt),
        "wk": normal(gen, (*lead, d, kv * hd), s, dt),
        "wv": normal(gen, (*lead, d, kv * hd), s, dt),
        "wo": normal(gen, (*lead, h * hd, d),
                     s / math.sqrt(2 * cfg.num_layers), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = full(gen, (*lead, hd), 1.0, dt)
        p["k_norm"] = full(gen, (*lead, hd), 1.0, dt)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, kv, hd)
    v = (x @ p["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:                         # before RoPE, as the reference
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_style == "rope":
        rot = hd if cfg.rope_style == "full" else hd // 2
        sin, cos = rope_angles(positions, rot, cfg.rope_theta)
        q = apply_rope(q, sin, cos, cfg.rope_style)
        k = apply_rope(k, sin, cos, cfg.rope_style)
    return q, k, v


def _pick_q_block(S: int) -> int:
    """Static query-block size: <=16 blocks, >=512 wide (1 block if S is
    small)."""
    if S <= 1024:
        return S
    qb = max(512, -(-S // 16))
    while S % qb:
        qb += 1
    return qb


def attention(p, x, cfg, positions, q_block: Optional[int] = None):
    """Blocked causal attention (prefill).

    Queries run in static blocks; block i reads keys [lo_i, (i+1)·qb),
    where lo_i honours the sliding window, so the (S, S) score matrix is
    never materialized.  Scores are float32, masked with -1e30, and the
    probabilities are cast to x's dtype before the value product.

    Returns (out (B,S,D), cache (k, v)), k and v (B, S, KV, hd) after RoPE.
    """
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = h // kv
    q, k, v = _qkv(p, x, cfg, positions)

    qb = q_block or _pick_q_block(S)
    win = cfg.sliding_window
    outs = []
    for i in range(S // qb):
        q0, q1 = i * qb, (i + 1) * qb
        lo = 0 if not win else max(0, q0 - win)
        kc, vc = k[:, lo:q1], v[:, lo:q1]
        qg = q[:, q0:q1].reshape(B, qb, kv, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg, kc).float()
        scores = scores / math.sqrt(hd)
        qpos = positions[:, q0:q1, None]                 # (B,qb,1)
        kpos = positions[:, None, lo:q1]                 # (B,1,kc)
        mask = kpos <= qpos
        if win:
            mask = mask & (kpos > qpos - win)
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", probs, vc)
                    .reshape(B, qb, h * hd))
    out = torch.cat(outs, dim=1)
    return out @ p["wo"], (k, v)


def attention_decode(p, x, cfg, cache, cache_len):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache: (k, v) each (B, S_cache, KV, hd); cache_len: (B,)
    current lengths.  The new token's k and v are written IN PLACE at
    position cache_len of each row (a row whose cache_len is past the
    cache writes nothing, as the reference's masked select); keys at
    positions <= cache_len (and inside the window) are attended.
    Returns (out (B,1,D), the same cache tensors).
    """
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = h // kv
    ck, cv = cache
    S = ck.shape[1]
    pos = cache_len[:, None]                                   # (B,1)
    q, knew, vnew = _qkv(p, x, cfg, pos)

    rows = torch.arange(B, device=ck.device)
    at = cache_len.clamp(max=S - 1)
    inside = (cache_len < S)[:, None, None]
    ck[rows, at] = torch.where(inside, knew[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(inside, vnew[:, 0].to(cv.dtype), cv[rows, at])

    qg = q.reshape(B, 1, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float()
    scores = scores / math.sqrt(hd)
    kpos = torch.arange(S, device=ck.device)[None, :]
    valid = kpos <= cache_len[:, None]
    if cfg.sliding_window:
        valid = valid & (kpos > (cache_len[:, None] - cfg.sliding_window))
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, cv).reshape(B, 1, h * hd)
    return out @ p["wo"], (ck, cv)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, lead=()):
    d, f = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "w1": normal(gen, (*lead, d, f), s, dt),
        "w3": normal(gen, (*lead, d, f), s, dt),
        "w2": normal(gen, (*lead, f, d), 1.0 / math.sqrt(f), dt),
    }


def mlp(p, x):
    hgate = x @ p["w1"]
    hup = x @ p["w3"]
    return (F.silu(hgate) * hup) @ p["w2"]
