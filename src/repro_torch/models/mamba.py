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
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(K))
    return out + b[None, None], xp[:, -(K - 1):]


def _ssm_scan(u, delta, A, B, C, Dc, h0):
    """u/delta: (B,S,DI); A: (DI,NS); B/C: (B,S,NS); h0: (B,DI,NS), all
    float32.  Returns (y (B,S,DI), h after the last step)."""
    h = h0
    ys = []
    for t in range(u.shape[1]):
        u_t, d_t, b_t, c_t = u[:, t], delta[:, t], B[:, t], C[:, t]
        dA = torch.exp(d_t[..., None] * A[None])                # (B,DI,NS)
        h = dA * h + (d_t * u_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    y = torch.stack(ys, dim=1)
    return y + u * Dc[None, None], h


def mamba(p, x, cfg, state=None):
    """Full-sequence forward.  Returns (out, (conv_state, h_state))."""
    B, S, D = x.shape
    DI, NS, R = d_inner(cfg), cfg.mamba_d_state, dt_rank(cfg)
    conv_state = None if state is None else state[0]
    h0 = (torch.zeros(B, DI, NS, dtype=torch.float32, device=x.device)
          if state is None else state[1])

    xz = x @ p["in_proj"]
    u, z = torch.split(xz, DI, dim=-1)
    u, new_conv = _conv_causal(u, p["conv_w"], p["conv_b"], conv_state)
    u = F.silu(u).float()

    proj = u.to(p["x_proj"].dtype) @ p["x_proj"]
    dt_in, Bm, Cm = torch.split(proj.float(), [R, NS, NS], dim=-1)
    delta = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["a_log"])

    y, hT = _ssm_scan(u, delta, A, Bm, Cm, p["dcoef"], h0)
    out = (y * F.silu(z.float())).to(p["out_proj"].dtype)
    out = out @ p["out_proj"]
    return out.to(x.dtype), (new_conv, hT)


def mamba_decode(p, x1, cfg, state):
    """One-token step.  state = (conv window (B,K-1,DI), h (B,DI,NS))."""
    return mamba(p, x1, cfg, state)
