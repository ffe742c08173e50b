"""AdamW + cosine schedule on nested dicts of tensors, ported from
`repro.optim.adamw` (no `torch.optim`).

The arithmetic is the reference's: each leaf's update is computed in
float32 and cast back to the parameter's dtype (a bfloat16 parameter has
no float32 master copy), the bias corrections come from `step + 1`, and
the decay is inside the update, `lr · (m̂/(√v̂ + eps) + wd·p)`, for every
leaf.  `torch.optim.AdamW` decays as `p *= 1 - lr·wd` first, which rounds
differently.  `moments_dtype="bfloat16"` keeps m and v in bfloat16.

The tensors are updated IN PLACE: the card holds one copy of the
parameters and moments, not the functional copy the reference's jit
donates away.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"   # or "bfloat16" for very large models


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to `lr`, then a cosine down to `min_lr_ratio · lr`,
    in float32 (a 0-d tensor on `step`'s device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def moments_torch_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moments_dtype == "bfloat16" \
        else torch.float32


def map_tree(fn, tree: dict, *rest: dict) -> dict:
    """`fn` over the leaves of nested dicts of one structure."""
    return {k: map_tree(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def init_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments shaped as `params` (on their devices) and step 0."""
    dt = moments_torch_dtype(cfg)
    # zeros_like: a DTensor parameter gets moments of its own placements
    zeros = lambda p: torch.zeros_like(p, dtype=dt,
                                       memory_format=torch.contiguous_format)
    dev = next(leaves(params)).device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def leaves(tree: dict):
    """The leaves of nested dicts, in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def _like_param(g, p):
    """A DTensor gradient laid out as its parameter (sharding propagation
    may leave it in another layout); a plain tensor as it is."""
    pl = getattr(p, "placements", None)
    if pl is None or tuple(g.placements) == tuple(pl):
        return g
    return g.redistribute(p.device_mesh, pl)


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict,
                  cfg: AdamWConfig) -> tuple[dict, dict]:
    """One AdamW step over every leaf, in place.  Returns (params, the new
    optimizer state); the parameter and moment tensors are the ones
    passed in, updated."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.to(torch.float32)
    c2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        # The reference's expression, one rounding per operation in its
        # order, computed in place in two float32 scratch tensors:
        #   m' = b1·m + (1 − b1)·g,  v' = b2·v + ((1 − b2)·g)·g,
        #   p' = p − lr·((m'/c1)/(√(v'/c2) + eps) + wd·p).
        # A float32 leaf (and moment) is updated where it lies; a
        # bfloat16 one through a float32 copy, cast back at the end.
        f32 = torch.float32
        g = _like_param(g, p)
        g32, m32, v32, p32 = (a.to(f32) for a in (g, m, v, p))
        t = torch.mul(g32, 1 - b1)
        m32.mul_(b1).add_(t)
        torch.mul(g32, 1 - b2, out=t).mul_(g32)
        v32.mul_(b2).add_(t)
        u = torch.div(v32, c2).sqrt_().add_(cfg.eps)
        torch.div(m32, c1, out=t).div_(u)
        t.add_(torch.mul(p32, cfg.weight_decay, out=u))
        p32.sub_(t.mul_(lr))
        for a, a32 in ((p, p32), (m, m32), (v, v32)):
            if a32 is not a:
                a.copy_(a32)

    map_tree(upd, params, grads, state["mu"], state["nu"])
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}
