"""Transformer building blocks: RMSNorm, RoPE (full/half), GQA attention
(qk-norm, sliding-window, decode-with-cache), SwiGLU MLP.

Ported from `repro.models.layers` as plain torch ops on tensors, with the
reference's parameter dicts and weight layouts: W_q is (d_model, H·hd)
and every product is `x @ w` over the same axis as the reference's
`einsum`.  The reference's sharding constraints are `shd.shard` calls
at the same points with the same logical axes: the identity on one
device, a DTensor redistribution on a mesh (`repro_torch.train.sharding`).

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

from repro_torch.train import sharding as shd


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
    q = shd.shard(x @ p["wq"], ("batch", "seq", "heads_flat"))
    q = shd.whole_groups(q, h).reshape(B, S, h, hd)
    k = shd.whole_groups(x @ p["wk"], kv).reshape(B, S, kv, hd)
    v = shd.whole_groups(x @ p["wv"], kv).reshape(B, S, kv, hd)
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
    probabilities are cast to x's dtype before the value product.  On a
    mesh the blocks run on each rank's own (batch, head) shard
    (`_attention_mesh`).

    Returns (out (B,S,D), cache (k, v)), k and v (B, S, KV, hd) after RoPE.
    """
    q, k, v = _qkv(p, x, cfg, positions)
    q = shd.shard(q, ("batch", "seq", "heads", None))
    k = shd.shard(k, ("batch", "seq", "kv_heads", None))
    v = shd.shard(v, ("batch", "seq", "kv_heads", None))
    qb = q_block or _pick_q_block(x.shape[1])
    if shd.is_sharded(q):
        out = _attention_mesh(q, k, v, positions, cfg, qb)
    else:
        out = _attention_blocks(q, k, v, positions, cfg, qb)
    return shd.shard(out @ p["wo"], ("batch", "seq", None)), (k, v)


def _attention_blocks(q, k, v, positions, cfg, qb):
    """The blocked causal attention of q (B,S,H,hd) over k, v (B,S,KV,hd),
    H a multiple of KV: (B, S, H·hd)."""
    B, S, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
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
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", probs, vc)
                    .reshape(B, qb, h * hd))
    return torch.cat(outs, dim=1)


def _kv_heads_for(q_off: int, h_loc: int, g: int) -> slice:
    """The KV heads that query heads [q_off, q_off + h_loc) read (g query
    heads a KV head); the local heads must cover whole groups or lie in
    one."""
    first, last = q_off // g, (q_off + h_loc - 1) // g
    if (h_loc >= g and (h_loc % g or q_off % g)) or \
            (h_loc < g and g % h_loc):
        raise ValueError(f"query heads [{q_off}, {q_off + h_loc}) split a "
                         f"KV group of {g}")
    return slice(first, last + 1)


def _attention_mesh(q, k, v, positions, cfg, qb):
    """`_attention_blocks` on DTensors: every (batch, head) pair is
    independent, so each rank runs the blocks on its own shard of q and
    the KV heads those query heads read, as local tensors.  DTensor's
    propagation of the grouped einsums would merge a batch and a head
    dimension sharded over two mesh axes (a strided shard) that its
    rules cannot follow under fake tensors; local blocks are also what a
    fused kernel would run.  Where k and v are replicated over an axis
    that shards the query heads (fewer KV heads than the axis), each
    rank reads a slice of them, so their local gradients are partial
    sums over that axis."""
    from torch.distributed.tensor import Partial, Shard
    mesh = q.device_mesh
    h = q.shape[2]
    g = h // k.shape[2]
    heads_split = [isinstance(a, Shard) and a.dim == 2 and
                   not (isinstance(b, Shard) and b.dim == 2)
                   for a, b in zip(q.placements, k.placements)]
    kv_grad = [Partial() if split else b
               for split, b in zip(heads_split, k.placements)]
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    off = shd.local_offset(q)
    if any(heads_split):
        sel = _kv_heads_for(off[2], ql.shape[2], g)
        kl, vl = kl[:, :, sel], vl[:, :, sel]
    pos = positions.to_local() if shd.is_sharded(positions) else positions
    if pos.shape[0] != ql.shape[0]:     # positions not sharded like q
        pos = pos[off[0]:off[0] + ql.shape[0]]
    out = _attention_blocks(ql, kl, vl, pos, cfg, qb)
    B, S = q.shape[:2]
    return shd.from_local_like(out, mesh, q.placements,
                               (B, S, h * q.shape[3]))


def attention_decode(p, x, cfg, cache, cache_len):
    """One-token decode against a KV cache.

    x: (B, 1, D); cache: (k, v) each (B, S_cache, KV, hd); cache_len: (B,)
    current lengths.  The new token's k and v are written IN PLACE at
    position cache_len of each row (a row whose cache_len is past the
    cache writes nothing, as the reference's masked select); keys at
    positions <= cache_len (and inside the window) are attended.  On a
    mesh see `_attention_decode_mesh`.
    Returns (out (B,1,D), the same cache tensors).
    """
    B = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = h // kv
    ck, cv = cache
    S = ck.shape[1]
    pos = cache_len[:, None]                                   # (B,1)
    q, knew, vnew = _qkv(p, x, cfg, pos)
    if shd.is_sharded(ck):
        out = _attention_decode_mesh(q, knew, vnew, ck, cv, cache_len, cfg)
        return out @ p["wo"], (ck, cv)

    rows = torch.arange(B, device=ck.device)
    at = cache_len.clamp(max=S - 1)
    inside = (cache_len < S)[:, None, None]
    ck[rows, at] = torch.where(inside, knew[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(inside, vnew[:, 0].to(cv.dtype), cv[rows, at])
    ck = shd.shard(ck, ("batch", "cache_seq", "kv_heads", None))
    cv = shd.shard(cv, ("batch", "cache_seq", "kv_heads", None))

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


def _attention_decode_mesh(q, knew, vnew, ck, cv, cache_len, cfg):
    """Decode against a cache sharded over the batch and the cache's
    sequence (the reference's decode recipes: `cache_seq` over "model",
    or over ("data", "model") at long context; the KV heads whole).
    Each rank writes the new k/v row where its sequence shard holds
    position cache_len, scores its shard for every query head, and the
    shards' softmaxes are merged flash-decoding style: the max, the
    rescaled sums and the rescaled value products all-reduced over the
    sequence axes.  Returns (B, 1, H·hd), sharded over the batch."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = ck.device_mesh
    if any(isinstance(a, Shard) and a.dim >= 2 for a in ck.placements):
        raise ValueError("mesh decode needs whole KV heads in the cache "
                         "(the decode rules map kv_heads to None)")
    batch_pl = [a if isinstance(a, Shard) and a.dim == 0 else Replicate()
                for a in ck.placements]
    seq_dims = [d for d, a in enumerate(ck.placements)
                if isinstance(a, Shard) and a.dim == 1]

    def rows(t):
        return t.redistribute(mesh, batch_pl).to_local() \
            if shd.is_sharded(t) else t

    ql, kn, vn = rows(q), rows(knew), rows(vnew)
    cl = cache_len.redistribute(mesh, [a if isinstance(a, Shard) else
                                       Replicate() for a in batch_pl]
                                ).to_local() if shd.is_sharded(cache_len) \
        else cache_len
    ckl, cvl = ck.to_local(), cv.to_local()
    off = shd.local_offset(ck)
    if cl.shape[0] != ckl.shape[0]:       # a full cache_len on a mesh
        cl = cl[off[0]:off[0] + ckl.shape[0]]
    S, s0, S_loc = ck.shape[1], off[1], ckl.shape[1]
    B_loc = ckl.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = h // kv

    r = torch.arange(B_loc, device=ckl.device)
    at = cl - s0
    here = ((at >= 0) & (at < S_loc) & (cl < S))[:, None, None]
    at = at.clamp(0, S_loc - 1)
    ckl[r, at] = torch.where(here, kn[:, 0].to(ckl.dtype), ckl[r, at])
    cvl[r, at] = torch.where(here, vn[:, 0].to(cvl.dtype), cvl[r, at])

    qg = ql.reshape(B_loc, 1, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ckl).float()
    scores = scores / math.sqrt(hd)
    kpos = s0 + torch.arange(S_loc, device=ckl.device)[None, :]
    valid = kpos <= cl[:, None]
    if cfg.sliding_window:
        valid = valid & (kpos > (cl[:, None] - cfg.sliding_window))
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    m = scores.amax(-1, keepdim=True)
    for d in seq_dims:
        m = funcol.all_reduce(m, "max", (mesh, d))
    e = torch.exp(scores - m)
    den = e.sum(-1, keepdim=True)
    num = torch.einsum("bkgqs,bskh->bkgqh", e, cvl.float())
    for d in seq_dims:
        den = funcol.all_reduce(den, "sum", (mesh, d))
        num = funcol.all_reduce(num, "sum", (mesh, d))
    out = (num / den).to(ql.dtype)                      # (B, kv, g, 1, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B_loc, 1, h * hd)
    return shd.from_local_like(out, mesh, batch_pl, (ck.shape[0], 1, h * hd))


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
    hgate = shd.shard(hgate, ("batch", "seq", "ff"))
    return (F.silu(hgate) * hup) @ p["w2"]
