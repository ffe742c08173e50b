"""RWKV-6 "Finch" block: data-dependent-decay linear attention (time-mix)
+ squared-ReLU channel-mix.  [arXiv:2404.05892]  Ported from
`repro.models.rwkv` as plain torch ops.

Time-mix recurrence per head (head size N):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t · (diag(u) k_t^T v_t + S_{t-1})

with w_t = exp(-exp(ww_t)) a per-channel, data-dependent decay produced by
a low-rank MLP of the token-shifted input.

Prefill is the reference's chunked closed form (chunks of 32, a Python
loop over chunks carrying the float32 state): within a chunk the pairwise
decays exp(Lx[t] - L[s]) are computed as one exponent, which is <= 0
wherever it is kept (s < t); the entries at s >= t may overflow and are
masked away by `tril(k=-1)`, as in the reference.  Rewriting the factor as
exp(Lx)·exp(-L) would overflow on the kept entries.

Decode is the recurrence verbatim: O(1) state per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dtype, full, normal, uniform
from repro_torch.train import sharding as shd

LORA_DIM = 64


def init_timemix(gen, cfg, lead=()):
    D = cfg.d_model
    dt = _dtype(cfg)
    s = 1.0 / math.sqrt(D)
    f32 = torch.float32
    return {
        "mu": uniform(gen, (*lead, 5, D)),                  # r,k,v,g,w lerps
        "w0": full(gen, (*lead, D), -6.0, f32),             # slow decay init
        "wA": normal(gen, (*lead, D, LORA_DIM), s, f32),
        "wB": normal(gen, (*lead, LORA_DIM, D), 0.01, f32),
        "u": normal(gen, (*lead, D), 0.5, f32),
        "wr": normal(gen, (*lead, D, D), s, dt),
        "wk_r": normal(gen, (*lead, D, D), s, dt),
        "wv_r": normal(gen, (*lead, D, D), s, dt),
        "wg": normal(gen, (*lead, D, D), s, dt),
        "wo_r": normal(gen, (*lead, D, D),
                       s / math.sqrt(2 * cfg.num_layers), dt),
        "ln_x": full(gen, (*lead, D), 1.0, f32),        # per-head group norm
    }


def init_channelmix(gen, cfg, lead=()):
    D, Fd = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg)
    return {
        "mu_c": uniform(gen, (*lead, 2, D)),                # k,r lerps
        "ck": normal(gen, (*lead, D, Fd), 1.0 / math.sqrt(D), dt),
        "cv": normal(gen, (*lead, Fd, D), 1.0 / math.sqrt(Fd), dt),
        "cr": normal(gen, (*lead, D, D), 1.0 / math.sqrt(D), dt),
    }


def _shift(x, x_prev):
    """Token shift: x_{t-1}, with x_prev (B, D) for the first position."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix_inputs(p, x, xx):
    mu = p["mu"][:, None, None, :]                              # (5,1,1,D)
    lerp = x[None] + (xx - x)[None] * mu                        # (5,B,S,D)
    xr, xk, xv, xg, xw = lerp
    wd = p["wr"].dtype
    r = xr.to(wd) @ p["wr"]
    k = xk.to(wd) @ p["wk_r"]
    v = xv.to(wd) @ p["wv_r"]
    g = F.silu(xg.to(wd) @ p["wg"])
    ww = p["w0"] + torch.tanh(xw.float() @ p["wA"]) @ p["wB"]
    logw = -torch.exp(ww)                                   # log decay <= 0
    return r, k, v, g, logw


def _group_norm(x, scale, H, eps=64e-5):
    """Per-head layer norm over head channels (RWKV ln_x)."""
    B, S, D = x.shape
    xh = x.reshape(B, S, H, D // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, D) * scale).to(x.dtype)


def timemix(p, x, cfg, state=None, chunk: int = 32):
    """Full-sequence time-mix.  x: (B,S,D) -> (out, (x_last, S_state))."""
    B, S, D = x.shape
    H = cfg.num_heads
    N = D // H
    x_prev = (torch.zeros(B, D, dtype=x.dtype, device=x.device)
              if state is None else state[0])
    S0 = (torch.zeros(B, H, N, N, dtype=torch.float32, device=x.device)
          if state is None else state[1])

    xx = _shift(x, x_prev)
    r, k, v, g, logw = _mix_inputs(p, x, xx)
    if shd.is_sharded(r):
        out, S0 = _wkv_mesh(r, k, v, g, logw, p["u"], p["ln_x"], H, chunk)
    else:
        out, S0 = _wkv(r, k, v, g, logw, p["u"], p["ln_x"], S0, H, chunk)
    out = shd.shard(out.to(p["wo_r"].dtype) @ p["wo_r"],
                    ("batch", "seq", None))
    return out.to(x.dtype), (x[:, -1], S0)


def _wkv_mesh(r, k, v, g, logw, u, ln_x, H, chunk):
    """`_wkv` on DTensors: the recurrence is independent per (row, head),
    so each rank runs it on its own rows and heads as local tensors (the
    heads stay split where each shard holds whole heads).  Returns (out
    (B,S,D), the final state (B,H,N,N)), as DTensors."""
    from torch.distributed.tensor import Shard
    mesh = r.device_mesh
    B, S, D = r.shape
    N = D // H
    pl = shd.channel_layout(r, N)
    split = [isinstance(q, Shard) for q in pl]
    lay = [a.redistribute(mesh, pl) for a in (r, k, v, g, logw)]
    loc = [shd.to_local_for(a, split) for a in lay]
    off = shd.local_offset(lay[0])[2]
    D_loc = loc[0].shape[2]
    uu, ln = (shd.to_local_for(a, split)[off:off + D_loc]
              for a in (u, ln_x))
    H_loc = D_loc // N
    S0 = torch.zeros(loc[0].shape[0], H_loc, N, N, dtype=torch.float32,
                     device=loc[0].device)
    out, S_f = _wkv(*loc, uu, ln, S0, H_loc, chunk)
    st_pl = tuple(Shard(1) if isinstance(q, Shard) and q.dim else q
                  for q in pl)
    return (shd.from_local_like(out, mesh, pl, (B, S, D)),
            shd.from_local_like(S_f, mesh, st_pl, (B, H, N, N)))


def _wkv(r, k, v, g, logw, u, ln_x, S0, H, chunk):
    """The chunked WKV recurrence of H heads over r, k, v, logw (B,S,D),
    then the per-head group norm and the gate g: (out (B,S,D), the final
    state (B,H,N,N))."""
    B, S, D = r.shape
    N = D // H
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
    T = r.shape[1]
    nc = T // chunk

    def resh(a):
        return a.reshape(B, nc, chunk, H, N).float()

    rs, ks, vs, lw = resh(r), resh(k), resh(v), resh(logw)
    u = u.reshape(H, N)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = rs[:, c], ks[:, c], vs[:, c], lw[:, c]  # (B,c,H,N)
        L = torch.cumsum(lwc, dim=1)                            # inclusive
        Lx = L - lwc                                            # exclusive
        # inter-chunk: r_t decayed to chunk start @ carried state
        inter = torch.einsum("bthn,bhnm->bthm", rc * torch.exp(Lx), S0)
        # intra-chunk: pairwise decay exp(Lx[t] - L[s]) <= 1 for s < t
        dmat = torch.exp(Lx[:, :, None] - L[:, None])           # (b,t,s,h,n)
        att = torch.einsum("bthn,bshn,btshn->bhts", rc, kc, dmat)
        att = torch.where(tri[None, None], att, 0.0)
        intra = torch.einsum("bhts,bshm->bthm", att, vc)
        diag = torch.einsum("bthn,hn,bthn->bth", rc, u, kc)
        intra = intra + diag[..., None] * vc
        outs.append(inter + intra)                              # (b,c,h,m)
        # state: S_c = exp(L_c) * S0 + sum_s exp(L_c - L_s) k_s v_s
        Lend = L[:, -1][:, None]                                # (b,1,h,n)
        kdec = kc * torch.exp(Lend - L)
        S0 = torch.exp(Lend[:, 0])[..., None] * S0 \
            + torch.einsum("bshn,bshm->bhnm", kdec, vc)
    out = torch.stack(outs, dim=1).reshape(B, T, D)[:, :S]
    return _group_norm(out, ln_x, H) * g[:, :S].to(r.dtype), S0


def timemix_decode(p, x1, cfg, state):
    """One-token decode.  x1: (B,1,D); state: (x_prev (B,D), S (B,H,N,N))."""
    H = cfg.num_heads
    x_prev, S0 = state
    xx = x_prev[:, None]
    r, k, v, g, logw = _mix_inputs(p, x1, xx)
    if shd.is_sharded(r):
        out, S1 = _wkv_step_mesh(r, k, v, g, logw, p["u"], p["ln_x"], S0, H)
    else:
        out, S1 = _wkv_step(r, k, v, g, logw, p["u"], p["ln_x"], S0, H)
    out = out.to(p["wo_r"].dtype) @ p["wo_r"]
    return out.to(x1.dtype), (x1[:, -1], S1)


def _wkv_step(r, k, v, g, logw, u, ln_x, S0, H):
    """One token of the WKV recurrence of H heads, the group norm and the
    gate: (out (B,1,D), the next state (B,H,N,N))."""
    B, _, D = r.shape
    N = D // H
    rh = r.reshape(B, H, N).float()
    kh = k.reshape(B, H, N).float()
    vh = v.reshape(B, H, N).float()
    w = torch.exp(logw.reshape(B, H, N))
    u = u.reshape(H, N)
    kv = kh[..., :, None] * vh[..., None, :]                    # (B,H,N,N)
    o = torch.einsum("bhn,bhnm->bhm", rh, u[None, :, :, None] * kv + S0)
    S1 = w[..., None] * S0 + kv
    out = o.reshape(B, 1, D)
    return _group_norm(out, ln_x, H) * g.to(out.dtype), S1


def _wkv_step_mesh(r, k, v, g, logw, u, ln_x, S0, H):
    """`_wkv_step` on DTensors, each rank on its own rows and heads (as
    `_wkv_mesh`); S0 is the cache's (B,H,N,N) DTensor."""
    from torch.distributed.tensor import Shard
    mesh = r.device_mesh
    B, _, D = r.shape
    N = D // H
    pl = shd.channel_layout(r, N)
    split = [isinstance(q, Shard) for q in pl]
    lay = [a.redistribute(mesh, pl) for a in (r, k, v, g, logw)]
    loc = [shd.to_local_for(a, split) for a in lay]
    off = shd.local_offset(lay[0])[2]
    D_loc = loc[0].shape[2]
    uu, ln = (shd.to_local_for(a, split)[off:off + D_loc]
              for a in (u, ln_x))
    st_pl = tuple(Shard(1) if isinstance(q, Shard) and q.dim else q
                  for q in pl)
    out, S1 = _wkv_step(*loc, uu, ln, S0.redistribute(mesh, st_pl).to_local(),
                        D_loc // N)
    return (shd.from_local_like(out, mesh, pl, (B, 1, D)),
            shd.from_local_like(S1, mesh, st_pl, (B, H, N, N)))


def channelmix(p, x, cfg, state=None):
    """Squared-ReLU channel mix.  Returns (out, x_last)."""
    B, S, D = x.shape
    x_prev = (torch.zeros(B, D, dtype=x.dtype, device=x.device)
              if state is None else state)
    xx = _shift(x, x_prev)
    mu = p["mu_c"][:, None, None, :]
    xk, xr = x[None] + (xx - x)[None] * mu
    kk = shd.shard(xk.to(p["ck"].dtype) @ p["ck"], ("batch", "seq", "ff"))
    # the row-parallel product's partial sums are reduced before the gate:
    # a gate times a partial sum would leave partial gradients behind
    vv = shd.shard(torch.square(F.relu(kk)) @ p["cv"], ("batch", "seq", None))
    rr = torch.sigmoid(xr.to(p["cr"].dtype) @ p["cr"])
    return (rr * vv).to(x.dtype), x[:, -1]
