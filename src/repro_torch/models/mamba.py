"""Selective SSM (Mamba-1 style) block for the Jamba hybrid.  [Jamba:
arXiv:2403.19887; Mamba: arXiv:2312.00752]  Ported from
`repro.models.mamba` as plain torch ops.

    h_t = exp(Δ_t A) h_{t-1} + (Δ_t B_t) x_t        (ZOH discretization)
    y_t = C_t · h_t + D x_t,   out = y ⊙ silu(z)

Δ_t, B_t, C_t are input-dependent (the "selective" part).  The full
sequence runs the recurrence step by step in float32 (`_ssm_scan`: a
Python loop over time carrying h (B, d_inner, d_state); the exponents Δ·A
are <= 0, so it is unconditionally stable).  The reference's chunking is a
rematerialization device for the backward pass and pads with steps that
leave h unchanged, so the step sequence is the same.  Decode carries
(conv window, h) per layer: O(1) per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dev, _dtype, full, normal, uniform
from repro_torch.train import sharding as shd


def d_inner(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model


def dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba(gen, cfg, lead=()):
    D, DI, NS, R, KC = (cfg.d_model, d_inner(cfg), cfg.mamba_d_state,
                        dt_rank(cfg), cfg.mamba_conv)
    dt = _dtype(cfg)
    s = 1.0 / math.sqrt(D)
    f32 = torch.float32
    a = torch.arange(1, NS + 1, dtype=f32, device=_dev(gen))
    # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
    dt0 = torch.exp(uniform(gen, (*lead, DI), math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": normal(gen, (*lead, D, 2 * DI), s, dt),
        "conv_w": normal(gen, (*lead, KC, DI), 1.0 / math.sqrt(KC), dt),
        "conv_b": full(gen, (*lead, DI), 0.0, dt),
        "x_proj": normal(gen, (*lead, DI, R + 2 * NS), 1.0 / math.sqrt(DI),
                         dt),
        "dt_proj": normal(gen, (*lead, R, DI), 1.0 / math.sqrt(R), f32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "a_log": torch.log(a).expand(*lead, DI, NS).contiguous(),
        "dcoef": full(gen, (*lead, DI), 1.0, f32),
        "out_proj": normal(gen, (*lead, DI, D),
                           1.0 / math.sqrt(DI) / math.sqrt(2 * cfg.num_layers),
                           dt),
    }


def _conv_causal(x, w, b, conv_state=None):
    """Depthwise causal conv over seq.  x: (B,S,DI); w: (K,DI).
    Returns (out, the last K-1 inputs: the next call's conv_state)."""
    if shd.is_sharded(x):
        return _conv_causal_mesh(x, w, b, conv_state)
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    return out + b[None, None], xp[:, -(K - 1):]


def _conv_causal_mesh(x, w, b, conv_state=None):
    """`_conv_causal` on DTensors: the conv is depthwise and runs along
    each row, so each rank convolves its own rows and channels as local
    tensors (DTensor's padding of a sharded tensor is not to be relied
    on: torch 2.11 fails to plan its redistribution)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    Bsz, S, DI = x.shape
    K = w.shape[0]
    pl = shd.channel_layout(x, 1)
    split = [isinstance(q, Shard) for q in pl]
    chan = tuple(Shard(q.dim - 1) if isinstance(q, Shard) and q.dim
                 else Replicate() for q in pl)
    xs = x.redistribute(mesh, pl)
    xl = shd.to_local_for(xs, split)
    wl = shd.to_local_for(w.redistribute(mesh, chan), split)
    bl = shd.to_local_for(b.redistribute(mesh, tuple(
        Shard(0) if isinstance(q, Shard) else q for q in chan)), split)
    cs = None if conv_state is None else \
        conv_state.redistribute(mesh, pl).to_local()
    out, new = _conv_causal(xl, wl, bl, cs)
    return (shd.from_local_like(out, mesh, pl, (Bsz, S, DI)),
            shd.from_local_like(new, mesh, pl, (Bsz, K - 1, DI)))


# The dry run's count of the time loop (`launch.dryrun`): None runs every
# step; k runs the first k only and leaves the other outputs zero.  Each
# step runs the same ops on the same shapes, so two counts at two k give
# the loop's per-step terms, and the whole loop's by extrapolation.
SCAN_STEPS = [None]


def _ssm_scan(u, delta, A, B, C, Dc, h0):
    """u/delta: (B,S,DI); A: (DI,NS); B/C: (B,S,NS); h0: (B,DI,NS), all
    float32.  Returns (y (B,S,DI), h after the last step)."""
    h = h0
    ys = []
    steps = u.shape[1] if SCAN_STEPS[0] is None \
        else min(SCAN_STEPS[0], u.shape[1])
    for t in range(steps):
        u_t, d_t, b_t, c_t = u[:, t], delta[:, t], B[:, t], C[:, t]
        dA = torch.exp(d_t[..., None] * A[None])                # (B,DI,NS)
        h = dA * h + (d_t * u_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    y = torch.stack(ys, dim=1)
    if steps < u.shape[1]:                  # a counted sample (dry run)
        y = torch.cat([y, y.new_zeros(y.shape[0], u.shape[1] - steps,
                                      y.shape[2])], dim=1)
    return y + u * Dc[None, None], h


def _ssm_scan_mesh(u, delta, A, B, C, Dc, h0=None):
    """`_ssm_scan` on DTensors, from h0 (a DTensor) or a zero state: the
    scan is independent per (row, channel), so each rank scans its own
    rows and inner channels as local tensors (B and C, shared by the
    channels, are read whole).  Returns (y (B,S,DI), h (B,DI,NS)) as
    DTensors."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = u.device_mesh
    Bsz, S, DI = u.shape
    pl = shd.channel_layout(u, 1)
    split = [isinstance(q, Shard) for q in pl]
    rows = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                 for q in pl)
    chan = tuple(Shard(0) if isinstance(q, Shard) and q.dim else Replicate()
                 for q in pl)
    ul, dl = (shd.to_local_for(a.redistribute(mesh, pl), split)
              for a in (u, delta))
    Bl, Cl = (shd.to_local_for(a.redistribute(mesh, rows), split)
              for a in (B, C))
    Al, Dl = (shd.to_local_for(a.redistribute(mesh, chan), split)
              for a in (A, Dc))
    h_pl = tuple(Shard(1) if isinstance(q, Shard) and q.dim else q
                 for q in pl)
    h0 = h0.redistribute(mesh, h_pl).to_local() if h0 is not None else \
        torch.zeros(ul.shape[0], ul.shape[2], A.shape[1],
                    dtype=torch.float32, device=ul.device)
    y, h = _ssm_scan(ul, dl, Al, Bl, Cl, Dl, h0)
    return (shd.from_local_like(y, mesh, pl, (Bsz, S, DI)),
            shd.from_local_like(h, mesh, h_pl, (Bsz, DI, A.shape[1])))


def mamba(p, x, cfg, state=None):
    """Full-sequence forward.  Returns (out, (conv_state, h_state))."""
    B, S, D = x.shape
    DI, NS, R = d_inner(cfg), cfg.mamba_d_state, dt_rank(cfg)
    conv_state = None if state is None else state[0]
    h0 = None if state is None else state[1]

    xz = shd.shard(x @ p["in_proj"], ("batch", "seq", "d_inner"))
    u, z = torch.split(xz, DI, dim=-1)
    u, new_conv = _conv_causal(u, p["conv_w"], p["conv_b"], conv_state)
    u = F.silu(u).float()

    # the product over the sharded inner channels is reduced here: a
    # partial sum through softplus would be scattered over the sequence
    proj = shd.shard(u.to(p["x_proj"].dtype) @ p["x_proj"],
                     ("batch", "seq", None))
    dt_in, Bm, Cm = torch.split(proj.float(), [R, NS, NS], dim=-1)
    delta = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["a_log"])

    if shd.is_sharded(u):
        y, hT = _ssm_scan_mesh(u, delta, A, Bm, Cm, p["dcoef"], h0)
    else:
        if h0 is None:
            h0 = torch.zeros(B, DI, NS, dtype=torch.float32,
                             device=x.device)
        y, hT = _ssm_scan(u, delta, A, Bm, Cm, p["dcoef"], h0)
    out = (y * F.silu(z.float())).to(p["out_proj"].dtype)
    out = out @ p["out_proj"]
    return shd.shard(out.to(x.dtype), ("batch", "seq", None)), \
        (new_conv, hT)


def mamba_decode(p, x1, cfg, state):
    """One-token step.  state = (conv window (B,K-1,DI), h (B,DI,NS))."""
    return mamba(p, x1, cfg, state)
