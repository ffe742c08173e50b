"""Training step: loss (CE + MoE aux + z-loss), gradients, AdamW update,
per-block remat and microbatches.  Ported from `repro.train.step`.

The train state is {"model": a `Transformer` whose parameters take
gradients, "opt": {"mu", "nu", "step"}}; the reference's state is
{"params", "opt"}, and `model.params.tree()` is its "params".  A step
updates the state in place and returns it with its metrics (0-d tensors
on the model's device; reading one waits for the step).

    state = init_train_state(seed, cfg, tcfg, device)
    step = make_train_step(cfg, tcfg)
    state, metrics = step(state, {"inputs": ..., "labels": ...})

On a `DeviceMesh` (`shard_state`), the parameters and both moments are
DTensors laid out by `train.sharding.tree_param_specs`, the batch is
sharded by the `batch` rule, and the step runs inside
`sharding.use_mesh_rules`: the same code, DTensor's sharding propagation
inserting the collectives.  The metrics are then replicated 0-d
DTensors (`scalar` reads one).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import sharding as shd


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's training options, less its `unroll` and
    `ce_unroll`: those set how XLA unrolls its scans, for the dry run's
    cost accounting, and eager PyTorch has no scan to unroll."""
    optimizer: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-4
    remat: str = "full"            # full | dots | none
    ce_chunks: int = 16            # chunked big-vocab CE (never materialize
                                   # the full (tokens, vocab) logits)
    microbatches: int = 1          # gradient accumulation (activation peak /k)


def cross_entropy(logits, labels, z_loss_weight: float = 0.0):
    """Mean CE over all positions.  logits (B,S,V), upcast to float32;
    labels (B,S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = (lse - gold).mean()
    if z_loss_weight:
        ce = ce + z_loss_weight * torch.square(lse).mean()
    return ce


def _ce_chunk(xc, lm_head, lc):
    """One chunk's (sum of lse − gold, sum of lse²): the logits in the
    model dtype, then float32.  The gold logit is a gather: the
    reference's masked sum adds exact zeros to it, so the two are equal.
    Each gathered position is hit once, so its backward (a scatter-add
    into zeros) has no colliding adds and the same bits on every run."""
    logits = shd.shard((xc @ lm_head).to(torch.float32),
                       ("batch", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    if shd.is_sharded(logits):
        # the reference's masked sum: it needs no gather across the
        # vocab shards (and adds exact zeros, so it equals the gather)
        vids = torch.arange(logits.shape[-1], device=lc.device)
        gold = torch.where(vids == lc[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return (lse - gold).sum(), torch.square(lse).sum()


def chunked_cross_entropy(x, lm_head, labels, z_loss_weight: float = 0.0,
                          num_chunks: int = 16):
    """CE without materializing the (tokens, vocab) logits: project and
    reduce one chunk of the sequence at a time.

    x: (B,S,D) final hidden; lm_head: (D,V); labels: (B,S).  `num_chunks`
    is halved until it divides S, and chunks run along the sequence, as
    the reference's.  Each chunk is checkpointed and keeps nothing (the
    reference's `nothing_saveable`): backward recomputes its logits, so
    the peak holds one chunk's (B, S/num_chunks, V) float32 logits."""
    B, S, _ = x.shape
    T = B * S
    while S % num_chunks:
        num_chunks //= 2
    c = S // num_chunks
    ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        cs, zs = ckpt.checkpoint(_ce_chunk, x[:, i * c:(i + 1) * c], lm_head,
                                 labels[:, i * c:(i + 1) * c],
                                 use_reentrant=False)
        ce_sum = ce_sum + cs
        z_sum = z_sum + zs
    ce = ce_sum / T
    if z_loss_weight:
        ce = ce + z_loss_weight * z_sum / T
    return ce


def make_loss_fn(cfg, tcfg: TrainConfig):
    """loss_fn(model, batch) -> (total, {"ce", "aux"}); remat is applied
    per block inside `forward_hidden`."""
    def loss_fn(model, batch):
        x, aux, _ = model.forward_hidden(batch["inputs"], remat=tcfg.remat)
        loss = chunked_cross_entropy(
            x, shd.gather_fsdp(model.params["lm_head"], "lm_head"),
            batch["labels"], tcfg.z_loss_weight, tcfg.ce_chunks)
        total = loss + tcfg.aux_loss_weight * aux
        return total, {"ce": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    metrics: "loss" (ce + aux_loss_weight·aux), "ce" (z-loss included),
    "aux", "grad_norm" (√ of the float32 sum of squares over every
    gradient leaf) and "lr" (the schedule at the new step).  With
    `microbatches = k` the batch is split into k along its first axis;
    each microbatch's gradients are added into the parameters' `.grad`,
    in the parameters' dtype, and the sums divided by k, as the
    reference's scan accumulates them."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def _grads(model, params, batch):
        k = max(tcfg.microbatches, 1)
        mbs = [{n: a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))[i]
                for n, a in batch.items()} for i in range(k)] if k > 1 \
            else [batch]
        tot = ce = aux = 0.0
        for mb in mbs:
            t, met = loss_fn(model, mb)
            t.backward()
            tot = tot + t.detach()
            ce = ce + met["ce"].detach()
            aux = aux + met["aux"].detach()
        grads = adamw.map_tree(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            params)
        if k > 1:
            grads = adamw.map_tree(lambda g: g / k, grads)
            tot, ce, aux = tot / k, ce / k, aux / k
        return (tot, {"ce": ce, "aux": aux}), grads

    def train_step(state, batch):
        model = state["model"]
        params = model.params.tree()
        model.zero_grad(set_to_none=True)
        (total, metrics), grads = _grads(model, params, batch)
        _, opt = adamw.apply_updates(params, grads, state["opt"],
                                     tcfg.optimizer)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in adamw.leaves(grads)))
        model.zero_grad(set_to_none=True)
        return {"model": model, "opt": opt}, {
            "loss": total, "ce": metrics["ce"], "aux": metrics["aux"],
            "grad_norm": gnorm,
            "lr": adamw.schedule(tcfg.optimizer, opt["step"])}

    return train_step


def train_state(model: transformer.Transformer, tcfg: TrainConfig,
                opt: dict = None) -> dict:
    """The train state of `model` (its parameters now take gradients),
    with zero moments unless `opt` is given."""
    model.requires_grad_(True)
    if opt is None:
        opt = adamw.init_state(model.params.tree(), tcfg.optimizer)
    return {"model": model, "opt": opt}


def shard_state(state: dict, mesh, overrides=None) -> dict:
    """`state` laid out on `mesh`: every parameter and both of its
    moments distributed by `tree_param_specs` under the rules of
    `overrides` (each rank keeps its own shards; the full tensors must
    be equal on every rank, as weights drawn from one seed are)."""
    model = state["model"]
    rules = shd.make_rules(mesh, overrides)
    params = {k: v for k, v in adamw.map_tree(
        lambda p: p.detach(), model.params.tree()).items()}
    specs = shd.tree_param_specs(params, mesh, rules)
    dmodel = transformer.Transformer(
        model.cfg, shd.distribute_tree(params, specs, mesh),
        device=model.device)
    opt = {m: shd.distribute_tree(state["opt"][m], specs, mesh)
           for m in ("mu", "nu")}
    opt["step"] = state["opt"]["step"]
    dmodel.requires_grad_(True)
    return {"model": dmodel, "opt": opt}


def unshard_state(state: dict) -> dict:
    """A sharded train state gathered into full tensors on every rank
    (a collective: every rank of the mesh calls it)."""
    model = state["model"]
    full = transformer.Transformer(
        model.cfg, shd.full_tree(adamw.map_tree(
            lambda p: p.detach(), model.params.tree())),
        device=model.device)
    opt = {m: shd.full_tree(state["opt"][m]) for m in ("mu", "nu")}
    opt["step"] = state["opt"]["step"]
    full.requires_grad_(True)
    return {"model": full, "opt": opt}


def scalar(x) -> float:
    """A 0-d metric as a float (a DTensor's full value)."""
    return float(x.full_tensor() if shd.is_sharded(x) else x)


def init_train_state(seed: int, cfg, tcfg: TrainConfig,
                     device=None) -> dict:
    """`cfg`'s weights drawn from `seed` on `device` (None means the card
    and raises without one) and zero moments."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = transformer.init_params(gen, cfg)
    return train_state(transformer.Transformer(cfg, params, device=dev), tcfg)
