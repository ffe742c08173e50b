"""Fake-tensor stand-ins and layouts for every (arch × input shape)
workload, ported from `repro.launch.specs`: the dry run never allocates.

For each shape kind, `lowerable_for` returns a function that runs, on
DTensors of fake tensors laid out by the sharding rules:

  train_4k    -> the train step (loss, backward, AdamW) on the train state
  prefill_32k -> the forward over the prompt, collecting the caches
  decode_*    -> one `decode_step` against caches of seq_len

decode_32k uses `sharding.DECODE_OVERRIDES` (batch over "data", the
cache's sequence over "model"), long_500k `LONG_CONTEXT_OVERRIDES` (the
cache's sequence over both).  Where the reference's `train_lowerable`
etc. hand XLA abstract arrays to lower, these run the port's own step
under a `FakeTensorMode`: shapes, dtypes and layouts without storage, so
the counters of `launch.roofline` see every op of one rank.

Fake tensors carry only a device type.  Autograd needs a device guard for
it, which a CPU-only build of torch lacks for CUDA, so `fake_device()`
is "cuda" on a CUDA build and "cpu" otherwise; no count depends on it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import sharding as shd
from repro_torch.train import step as train_step_lib


def moments_dtype_for(cfg: ArchConfig) -> str:
    """bf16 Adam moments for models whose f32 moments would blow the
    memory budget (jamba-398b, dbrx-132b); f32 elsewhere."""
    big = cfg.d_model * cfg.d_ff * cfg.num_layers
    if cfg.num_experts:
        big *= cfg.num_experts
    return "bfloat16" if big > 2**40 else "float32"


def make_train_cfg(cfg: ArchConfig, microbatches: int = 1,
                   remat: str = "full") -> train_step_lib.TrainConfig:
    """The reference's dry-run training config, less `unroll`/`ce_unroll`
    (the port's loops are eager: the counters see every iteration)."""
    return train_step_lib.TrainConfig(
        optimizer=adamw.AdamWConfig(moments_dtype=moments_dtype_for(cfg)),
        remat=remat, microbatches=microbatches)


def skip_reason(cfg: ArchConfig, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full quadratic attention, no sliding-window variant: "
                "long_500k requires sub-quadratic attention (DESIGN.md §5)")
    return None


def fake_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def with_blocks(cfg: ArchConfig, blocks: int) -> ArchConfig:
    """`cfg` cut to `blocks` blocks of its pattern (the accounting's 1 and
    u2 block models)."""
    return dataclasses.replace(cfg, num_layers=blocks
                               * len(cfg.block_pattern))


# ---------------------------------------------------------------------------
# Abstract state / batch / caches (call inside a FakeTensorMode)
# ---------------------------------------------------------------------------

def _fake_like(tree: dict, device) -> dict:
    return adamw.map_tree(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                                device=device), tree)


def abstract_params(cfg: ArchConfig, device) -> dict:
    return _fake_like(transformer.init_params(None, cfg), device)


def abstract_state(cfg: ArchConfig, tcfg, mesh, rules_overrides=None,
                   device=None) -> dict:
    """The train state laid out on `mesh` (params and both moments by
    `tree_param_specs`)."""
    model = transformer.Transformer(cfg, abstract_params(cfg, device),
                                    device=device)
    return train_step_lib.shard_state(
        train_step_lib.train_state(model, tcfg), mesh, rules_overrides)


def _dtensor(shape, dtype, mesh, axes, rules, device):
    t = torch.empty(shape, dtype=dtype, device=device)
    return shd.distribute(t, mesh, shd.placements(
        shd.logical_spec(axes, mesh, rules, shape), mesh))


def batch_struct(cfg: ArchConfig, shape_name: str, mesh, rules, device):
    s = INPUT_SHAPES[shape_name]
    B, S = s["global_batch"], s["seq_len"]
    if cfg.input_mode == "tokens":
        inputs = _dtensor((B, S), torch.int64, mesh, ("batch", "seq"),
                          rules, device)
    else:
        inputs = _dtensor((B, S, cfg.d_model), torch.bfloat16, mesh,
                          ("batch", "seq", None), rules, device)
    labels = _dtensor((B, S), torch.int64, mesh, ("batch", "seq"), rules,
                      device)
    return {"inputs": inputs, "labels": labels}


_CACHE_AXES = {
    "k":    (None, "batch", "cache_seq", "kv_heads", None),
    "v":    (None, "batch", "cache_seq", "kv_heads", None),
    "conv": (None, "batch", None, "d_inner"),
    "h":    (None, "batch", "d_inner", "state"),
    "x_tm": (None, "batch", None),
    "x_cm": (None, "batch", None),
    "S":    (None, "batch", "heads", None, None),
}


def cache_placements(cfg: ArchConfig, batch: int, max_seq: int, mesh,
                     rules) -> dict:
    """{position: {cache name: placements}} of `init_cache`'s tree."""
    shapes = transformer.init_cache(cfg, batch, max_seq, device="meta")
    return {pos: {name: shd.placements(shd.logical_spec(
        _CACHE_AXES[name], mesh, rules, tuple(t.shape)), mesh)
        for name, t in c.items()} for pos, c in shapes.items()}


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int, mesh, rules,
                   device) -> dict:
    pls = cache_placements(cfg, batch, max_seq, mesh, rules)
    shapes = transformer.init_cache(cfg, batch, max_seq, device="meta")
    return {pos: {name: shd.distribute(
        torch.empty(t.shape, dtype=t.dtype, device=device), mesh,
        pls[pos][name]) for name, t in c.items()}
        for pos, c in shapes.items()}


# ---------------------------------------------------------------------------
# Lowerables: functions that run one rank's step on fake DTensors
# ---------------------------------------------------------------------------

def train_lowerable(cfg: ArchConfig, shape_name: str, mesh, overrides=None,
                    device=None):
    """Returns (run, state): `run()` is one train step under the rules."""
    overrides = dict(overrides or {})
    mb = int(overrides.pop("microbatches", 1) or 1)
    remat = overrides.pop("remat", "full") or "full"
    rules = shd.make_rules(mesh, overrides)
    tcfg = make_train_cfg(cfg, microbatches=mb, remat=remat)
    state = abstract_state(cfg, tcfg, mesh, overrides, device)
    batch = batch_struct(cfg, shape_name, mesh, rules, device)
    step = train_step_lib.make_train_step(cfg, tcfg)

    def run():
        with shd.use_mesh_rules(mesh, overrides):
            return step(state, batch)

    return run, (state, batch)


def prefill_lowerable(cfg: ArchConfig, shape_name: str, mesh,
                      overrides=None, device=None):
    rules = shd.make_rules(mesh, overrides)
    params = abstract_params(cfg, device)
    specs = shd.tree_param_specs(params, mesh, rules)
    model = transformer.Transformer(
        cfg, shd.distribute_tree(params, specs, mesh), device=device)
    batch = batch_struct(cfg, shape_name, mesh, rules, device)

    def run():
        with torch.no_grad(), shd.use_mesh_rules(mesh, overrides):
            return model.forward(batch["inputs"], collect_cache=True)

    return run, (model, batch)


def decode_lowerable(cfg: ArchConfig, shape_name: str, mesh, overrides=None,
                     device=None):
    s = INPUT_SHAPES[shape_name]
    B, S = s["global_batch"], s["seq_len"]
    base = (shd.LONG_CONTEXT_OVERRIDES if shape_name == "long_500k"
            else shd.DECODE_OVERRIDES)
    overrides = dict(base, **(overrides or {}))
    rules = shd.make_rules(mesh, overrides)
    params = abstract_params(cfg, device)
    specs = shd.tree_param_specs(params, mesh, rules)
    model = transformer.Transformer(
        cfg, shd.distribute_tree(params, specs, mesh), device=device)
    caches = abstract_cache(cfg, B, S, mesh, rules, device)
    if cfg.input_mode == "tokens":
        inputs = _dtensor((B, 1), torch.int64, mesh, ("batch", None), rules,
                          device)
    else:
        inputs = _dtensor((B, 1, cfg.d_model), torch.bfloat16, mesh,
                          ("batch", None, None), rules, device)
    cache_len = _dtensor((B,), torch.int64, mesh, ("batch",), rules, device)

    def run():
        with torch.no_grad(), shd.use_mesh_rules(mesh, overrides):
            return model.decode_step(caches, inputs, cache_len)

    return run, (model, caches, inputs, cache_len)


def lowerable_for(cfg: ArchConfig, shape_name: str, mesh, overrides=None,
                  device=None):
    """(run, the state it runs on) of the shape's kind; call inside a
    FakeTensorMode."""
    device = device or fake_device()
    kind = INPUT_SHAPES[shape_name]["kind"]
    if kind == "train":
        return train_lowerable(cfg, shape_name, mesh, overrides, device)
    if kind == "prefill":
        return prefill_lowerable(cfg, shape_name, mesh, overrides, device)
    return decode_lowerable(cfg, shape_name, mesh, overrides, device)
