"""Mixture-of-Experts FFN: top-k router with a per-expert capacity, sort-
based dispatch and a deterministic combine.  Ported from `repro.models.moe`.
The reference routes per data shard (W = the mesh's batch factor): on one
device W = 1 and the whole token set is one shard; on a mesh
(`_moe_ffn_mesh`) each data shard routes its own tokens and the experts
run expert- and tensor-parallel.

Dispatch is the reference's: a stable argsort of the (token, k) entries by
expert, each entry's rank within its expert, and entries past `cap`
dropped (their output contribution is zero).  The combine differs in HOW
it sums, not in what: the reference scatter-adds each token's K
contributions (`zeros.at[st].add`), which on CUDA would be an atomic
`index_add_` whose float order, and so whose bits, change from run to run.
Here each token's contributions are gathered into a (T, K, D) buffer in
the reference's order (by expert id, as the sorted entries arrive) and
summed in float32 one k after another, then cast: the same bits on every
run and device, and in float32 the reference's sequential order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dtype, normal
from repro_torch.train import sharding as shd


def init_moe(gen, cfg, lead=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = _dtype(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "router": normal(gen, (*lead, d, e), s, torch.float32),
        "we1": normal(gen, (*lead, e, d, f), s, dt),
        "we3": normal(gen, (*lead, e, d, f), s, dt),
        "we2": normal(gen, (*lead, e, f, d), 1.0 / math.sqrt(f), dt),
    }


def capacity(T: int, cfg) -> int:
    """Slots per expert: max(4, ceil(T·K/E · capacity_factor))."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return max(4, int(math.ceil(T * K / E * cfg.capacity_factor)))


def _counts(ids, E: int):
    """Entries per expert (E,) int64: an integer scatter-add (exact in any
    order), where `bincount`'s output length would depend on the data."""
    return torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def route(p, xt, cfg):
    """Router of T tokens xt (T, D): (probs (T, E) float32, renormalised
    top-k gates (T, K), expert ids (T, K), aux load-balancing loss)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = xt.shape[0]
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(0)
    ce = _counts(eidx.reshape(-1), E).float() / (T * K)
    aux = E * torch.sum(me * ce)
    return probs, gate, eidx, aux


def dispatch(eidx, cap: int, E: int):
    """The reference's sorted dispatch of the flattened (token, k) entries:
    (order, slot_e, slot_c, keep), each over the entries sorted stably by
    expert; an entry is kept when its rank in its expert is below cap, and
    a dropped entry points at the last slot (E-1, cap-1)."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = _counts(se, E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.numel(), device=se.device) - offsets[se]
    keep = rank < cap
    slot_e = torch.where(keep, se, E - 1)
    slot_c = torch.where(keep, rank, cap - 1)
    return order, slot_e, slot_c, keep


def _dispatch_local(router, xt, cfg, cap):
    """Routing and dispatch of ONE shard's tokens xt (T, D): (xe (E, cap,
    D), the combine's (order, flat slots, keep, sorted gates), aux)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    D = xt.shape[1]
    _, gate, eidx, aux = route({"router": router}, xt, cfg)
    order, slot_e, slot_c, keep = dispatch(eidx, cap, E)
    st = torch.div(order, K, rounding_mode="floor")           # token per entry
    sg = gate.reshape(-1)[order]

    # kept entries fill distinct slots; dropped ones add zeros to the last
    # slot, so the accumulating put is exact in any order
    flat = slot_e * cap + slot_c
    xe = torch.zeros(E * cap, D, dtype=xt.dtype, device=xt.device)
    xe.index_put_((flat,), torch.where(keep[:, None], xt[st], 0.0),
                  accumulate=True)
    return xe.reshape(E, cap, D), (order, flat, keep, sg), aux


def _combine_local(ye, meta, T, K, dtype):
    """Each token's K expert outputs from ye (E·cap, D), gated and summed
    in the reference's order (see the module docstring): (T, D)."""
    order, flat, keep, sg = meta
    back = ye[flat]
    contrib = torch.where(keep[:, None], back * sg[:, None].to(dtype), 0.0)
    # entry j of the sorted list is token st[j]'s contribution; within a
    # token the sorted entries run by expert id, so ranking them by sorted
    # position puts each token's K contributions in the reference's order
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    by_token = torch.sort(pos.reshape(T, K), dim=1).values     # (T, K)
    buf = contrib[by_token].float()                            # (T, K, D)
    acc = buf[:, 0]
    for k in range(1, K):
        acc = acc + buf[:, k]
    return acc.to(dtype)


def _experts(xe, p):
    """SwiGLU of every expert over its slots: xe (E, C, D) -> (E, C, D)."""
    h = F.silu(torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"])
    return torch.bmm(h, p["we2"])


def _batch_shards(B: int) -> int:
    """How many ways the token dim is sharded on the active mesh (1 off
    the mesh), as the reference's `_batch_shards`."""
    mesh, rules = shd._mesh(), shd._rules()
    if mesh is None or rules is None or rules.get("batch") is None:
        return 1
    w = shd._axis_size(mesh, rules["batch"])
    return w if B % w == 0 else 1


def moe_ffn(p, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    if shd.is_sharded(x):
        return _moe_ffn_mesh(p, x, cfg)
    B, S, D = x.shape
    K = cfg.num_experts_per_tok
    T = B * S
    cap = capacity(T, cfg)
    xe, meta, aux = _dispatch_local(p["router"], x.reshape(T, D), cfg, cap)
    ye = _experts(xe, p).reshape(-1, D)
    return _combine_local(ye, meta, T, K, x.dtype).reshape(B, S, D), aux


def _moe_ffn_mesh(p, x, cfg):
    """The reference's mesh MoE on DTensors: routing per data shard (W =
    the mesh's batch factor, capacity per shard), the dispatched (W, E,
    cap, D) buffer resharded from W-over-batch to E-over-experts (an
    all_to_all), the experts tensor-parallel over "ff", and back.

    DTensor has no sharding rule for routing (top-k, sort, bincount,
    index_put_), so each rank routes its own shard's tokens as local
    tensors: every shard's routing is local by construction, as the
    reference vmaps it over W.  The router is gathered whole for it, and
    its local gradients are partial sums over the batch axes."""
    from torch.distributed.tensor import Replicate, Shard
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    W = _batch_shards(B)
    Tw = B * S // W
    cap = capacity(Tw, cfg)
    mesh = x.device_mesh
    rules = shd._rules()

    xw = shd.shard(x.reshape(W, Tw, D), ("batch", None, None))
    wpl = xw.placements
    split = [isinstance(q, Shard) for q in wpl]
    router = shd.to_local_for(p["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim), split)
    xe_l, meta_l, aux_l = [], [], []
    for xt in xw.to_local():                  # this rank's shards of W
        xe, meta, aux = _dispatch_local(router, xt, cfg, cap)
        xe_l.append(xe)
        meta_l.append(meta)
        aux_l.append(aux)
    aux = shd.from_local_like(torch.stack(aux_l), mesh, wpl, (W,)).mean()
    xe = shd.from_local_like(torch.stack(xe_l), mesh, wpl, (W, E, cap, D))

    ep_pure = shd.pure_ep(rules)
    wdim = "batch" if ep_pure else None
    xe = shd.shard(xe, (wdim, "experts", None, None))
    h1 = torch.einsum("wecd,edf->wecf", xe, p["we1"])
    h3 = torch.einsum("wecd,edf->wecf", xe, p["we3"])
    h = F.silu(h1) * h3
    h = shd.shard(h, (wdim, "experts", None, None if ep_pure else "ff"))
    ye = torch.einsum("wecf,efd->wecd", h, p["we2"])
    ye = shd.shard(ye, (wdim, "experts", None, None))

    # back to token-major sharding for the combine (reverse all_to_all)
    ye = shd.shard(ye, ("batch", None, None, None))
    if tuple(ye.placements) != tuple(wpl):
        ye = ye.redistribute(mesh, wpl)
    out = torch.stack([_combine_local(y.reshape(E * cap, D), m, Tw, K,
                                      x.dtype)
                       for y, m in zip(ye.to_local(), meta_l)])
    out = shd.from_local_like(out, mesh, wpl, (W, Tw, D)).reshape(B, S, D)
    return shd.shard(out, ("batch", "seq", None)), aux
