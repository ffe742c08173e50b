"""Mixture-of-Experts FFN: top-k router with a per-expert capacity, sort-
based dispatch and a deterministic combine.  Ported from `repro.models.moe`
on one device: the reference routes per data shard (W = the mesh's batch
factor); with one device W = 1, so the whole token set is one shard.

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
    ce = torch.bincount(eidx.reshape(-1), minlength=E).float() / (T * K)
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
    counts = torch.bincount(se, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.numel(), device=se.device) - offsets[se]
    keep = rank < cap
    slot_e = torch.where(keep, se, E - 1)
    slot_c = torch.where(keep, rank, cap - 1)
    return order, slot_e, slot_c, keep


def moe_ffn(p, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    cap = capacity(T, cfg)
    xt = x.reshape(T, D)
    _, gate, eidx, aux = route(p, xt, cfg)
    order, slot_e, slot_c, keep = dispatch(eidx, cap, E)
    st = torch.div(order, K, rounding_mode="floor")           # token per entry
    sg = gate.reshape(-1)[order]

    # kept entries fill distinct slots; dropped ones add zeros to the last
    # slot, so the accumulating put is exact in any order
    flat = slot_e * cap + slot_c
    xe = torch.zeros(E * cap, D, dtype=x.dtype, device=x.device)
    xe.index_put_((flat,), torch.where(keep[:, None], xt[st], 0.0),
                  accumulate=True)
    xe = xe.reshape(E, cap, D)
    h = F.silu(torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"])
    ye = torch.bmm(h, p["we2"]).reshape(E * cap, D)

    back = ye[flat]
    contrib = torch.where(keep[:, None], back * sg[:, None].to(x.dtype), 0.0)
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
    return acc.to(x.dtype).reshape(B, S, D), aux
