"""Multi-pod dry run, ported from `repro.launch.dryrun` and re-derived for
H100 clusters.

For every (architecture × input shape): build the step and its fake
inputs (`launch.specs`), run it once as rank 0 of a placeholder world
of 256 ranks on the (32, 8) production mesh, or 512 on (2, 32, 8)
(`launch.mesh.make_production_mesh`), and record one rank's peak memory
(its state's shards plus the peak of live tensors over the step, against
the card's 80 GB) and the roofline terms of `launch.roofline`.  Nothing is allocated and nothing communicates:
the world is torch's fake process group and the tensors are fake.

Accounting follows the reference: a model of 1 block and one of u2
blocks (2, or 3 when the block count is odd) are counted and every
additive figure, the memory peak included, is extrapolated linearly to
`num_blocks` (`roofline.extrapolate`).  A Mamba layer's time loop is
counted the same way, at 1 and 2 steps, extrapolated to the sequence.

`run_drf` does the same for the paper's own level step
(`core.distributed.drf_level_step_fn`, features over "model", presorted
rows over "data").  Its shapes depend on the data, which fake tensors do
not carry, so it runs rank 0's shard on real (CPU) tensors of made-up
values over the placeholder world, and reads the collective bytes from
the forest mesh's log: its numbers are sizes, and its values are not
results.

Every number printed is a prediction from counts and NVIDIA's published
figures (`launch.roofline`), not a measurement.  The reference's
`--hlo-dir` is gone: there is no HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--multi-pod | --both-meshes] [--drf] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES, get_arch, list_archs
from repro_torch.launch import mesh as mesh_lib, roofline, specs
from repro_torch.models import transformer

HBM_BYTES = 80e9        # one H100 SXM5 (NVIDIA datasheet: 80 GB HBM3)


def fake_world(world: int) -> None:
    """Make this process rank 0 of a placeholder world of `world` ranks
    (torch's fake process group), replacing any world it had."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def production_mesh(multi_pod: bool, shape=None):
    """The production DeviceMesh in a fake world of its size."""
    shape = tuple(shape) if shape else (mesh_lib.MULTI_POD_SHAPE if multi_pod
                                        else mesh_lib.PRODUCTION_SHAPE)
    size = 1
    for d in shape:
        size *= d
    fake_world(size)
    return mesh_lib.make_production_mesh(shape=shape,
                                         device_type=specs.fake_device())


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "params"):                 # a Transformer
        yield from tree.params.parameters()


def count_step(cfg, shape: str, mesh, overrides=None) -> dict:
    """One rank's `StepCounter.terms()` of the shape's step of `cfg` on
    `mesh`.  A Mamba layer's time loop (one step of ops a token) is
    counted at 1 and at 2 steps (`mamba.SCAN_STEPS`) and extrapolated to
    the sequence, as the blocks are: each step runs the same ops on the
    same shapes."""
    from repro_torch.models import mamba
    s = INPUT_SHAPES[shape]
    if s["kind"] == "decode" or s["seq_len"] <= 2 or not any(
            mix == "mamba" for mix, _ in cfg.block_pattern):
        return _count_step(cfg, shape, mesh, overrides)
    try:
        mamba.SCAN_STEPS[0] = 1
        t1 = _count_step(cfg, shape, mesh, overrides)
        mamba.SCAN_STEPS[0] = 2
        t2 = _count_step(cfg, shape, mesh, overrides)
    finally:
        mamba.SCAN_STEPS[0] = None
    return roofline.extrapolate(t1, t2, 1, 2, s["seq_len"])


def _count_step(cfg, shape: str, mesh, overrides=None) -> dict:
    """`count_step` of one run: "peak_bytes" adds the state's own shards
    (parameters, moments, batch, caches) to the step's peak of live
    tensors.  (`MemTracker` would also count the global-shape tensors that
    DTensor's shape inference makes, which no rank holds.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    with FakeTensorMode():
        run, state = specs.lowerable_for(cfg, shape, mesh, overrides)
        held = sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
                   for t in _tensors(state))
        with roofline.StepCounter(mesh) as counter:
            run()
    t = counter.terms()
    t["state_bytes"] = held
    t["peak_bytes"] = held + t["peak_bytes"]
    return t


def account(cfg, shape: str, mesh, overrides=None) -> dict:
    """The terms of the whole model from its 1-block and u2-block models
    (the reference's linear extrapolation)."""
    nb = cfg.num_blocks
    u2 = 2 if nb % 2 == 0 else (3 if nb % 3 == 0 else None)
    t1 = count_step(specs.with_blocks(cfg, 1), shape, mesh, overrides)
    if nb == 1:
        return t1
    if u2 is None:                      # an odd prime count: count it all
        return count_step(cfg, shape, mesh, overrides)
    t2 = count_step(specs.with_blocks(cfg, u2), shape, mesh, overrides)
    return roofline.extrapolate(t1, t2, 1, u2, nb)


def active_params(cfg) -> int:
    """Params touched per token (MoE experts scaled by top-k/E), from the
    parameter shapes alone."""
    model = transformer.Transformer(cfg, transformer.init_params(None, cfg),
                                    device="meta")
    return transformer.active_param_count(model)


def run_one(arch: str, shape: str, *, multi_pod: bool = False,
            overrides=None, verbose: bool = True, mesh=None,
            cfg=None) -> dict:
    """One (arch, shape) cell: {"status": "ok" | "skipped" | "error",
    "memory": {...}, "roofline": {...}}.  `mesh` (default: the
    production mesh) and `cfg` (default: the registered arch) may be
    given."""
    cfg = cfg or get_arch(arch)
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
           "predicted": True}
    reason = specs.skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        if verbose:
            print(f"SKIP {arch:24s} {shape:12s} {rec['mesh']:8s} {reason}",
                  flush=True)
        return rec
    chips = mesh.size()
    t0 = time.time()
    try:
        t = account(cfg, shape, mesh, overrides)
        mf = roofline.model_flops(cfg, shape, active_params(cfg))
        terms = roofline.extract(t, arch=arch, shape=shape,
                                 mesh_name=rec["mesh"], chips=chips,
                                 model_flops_global=mf)
        peak = float(t["peak_bytes"])
        rec.update(status="ok", count_s=round(time.time() - t0, 1),
                   memory={"peak_bytes_per_device": peak,
                           "hbm_bytes": HBM_BYTES,
                           "fits": peak <= HBM_BYTES},
                   n_active_params=int(active_params(cfg)),
                   roofline=terms.row())
        if verbose:
            r = terms.row()
            print(f"OK  {arch:24s} {shape:12s} {rec['mesh']:8s} "
                  f"mem/dev={peak / 2**30:8.2f}GiB "
                  f"{'fits' if rec['memory']['fits'] else 'OVER 80GB'} "
                  f"compute={r['compute_s'] * 1e3:10.3f}ms "
                  f"memory={r['memory_s'] * 1e3:10.3f}ms "
                  f"coll={r['collective_s'] * 1e3:10.3f}ms "
                  f"dom={r['dominant']:10s} "
                  f"useful={r['useful_flops_ratio']:.3f} (predicted)",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"ERR {arch:24s} {shape:12s} {rec['mesh']:8s} {e}",
                  flush=True)
    return rec


def run_drf(*, multi_pod: bool = False, verbose: bool = True,
            n: int = 2**22, m: int = 128, num_leaves: int = 255,
            backend: str = "segment", shape=None, seed: int = 0) -> dict:
    """One DRF supersplit level on the production mesh: rank 0's shard of
    (m presorted columns × n rows) over (model, data), on real CPU tensors
    in the placeholder world.  Reports the rank's peak memory, its FLOPs
    and bytes, and the level's collective bytes by axis from the forest
    mesh's log.  The collectives return no data, so the level's answers
    are not results; its sizes are."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.core import distributed
    shape = tuple(shape) if shape else (mesh_lib.MULTI_POD_SHAPE if multi_pod
                                        else mesh_lib.PRODUCTION_SHAPE)
    data, model = shape[-2], shape[-1]
    pods = shape[0] if len(shape) == 3 else 1
    rec = {"arch": "drf-level", "shape": f"n{n}_m{m}_L{num_leaves}",
           "mesh": "x".join(map(str, shape)), "backend": backend,
           "predicted": True,
           "note": "one rank on made-up values in a placeholder world: "
                   "sizes, not results"}
    try:
        fake_world(pods * data * model)
        # the pod axis replicates the level (a second group of nodes
        # trains other trees): the level's mesh is one pod's (data, model)
        fmesh = mesh_lib.make_mesh(data, model, backend="fake",
                                   device="cpu",
                                   ranks=list(range(data * model)))
        step = distributed.drf_level_step_fn(
            fmesh, num_leaves=num_leaves, num_classes=2, backend=backend)
        gen = torch.Generator().manual_seed(seed)
        # full-size arguments as broadcast views: the engine slices its
        # own shard and materializes only that
        rows = torch.arange(n, dtype=torch.int32)
        sorted_idx = rows[None].expand(m, n)
        sorted_vals = rows.to(torch.float32)[None].expand(m, n)
        leaf_of = torch.randint(0, num_leaves + 1, (n,), generator=gen,
                                dtype=torch.int32)
        labels = torch.randint(0, 2, (n,), generator=gen,
                               dtype=torch.int32)
        w = torch.ones(n, dtype=torch.float32)
        cand = torch.ones((m, num_leaves + 1), dtype=torch.bool)
        cand[:, 0] = False
        fmesh.reset_log()
        mt = MemTracker()
        t0 = time.time()
        with mt, roofline.StepCounter() as counter:
            step(sorted_vals, sorted_idx, leaf_of, labels, w, cand)
        rec["run_s"] = round(time.time() - t0, 1)
        peak = max(v["Total"] for v in
                   mt.get_tracker_snapshot("peak").values())
        by_axis = {}
        for e in fmesh.log:
            by_axis[e["axis"]] = by_axis.get(e["axis"], 0) + e["bytes"] * (
                2 if e["op"].startswith("all_reduce") else 1)
        t = counter.terms()
        t["by_axis"] = by_axis
        t["wire_bytes"] = sum(by_axis.values())
        t["collectives"] = {k: 0 for k in roofline.KINDS}
        t["collective_counts"] = {k: 0 for k in roofline.KINDS}
        for e in fmesh.log:
            kind = "all-gather" if e["op"] == "all_gather" else "all-reduce"
            t["collectives"][kind] += e["bytes"]
            t["collective_counts"][kind] += 1
        terms = roofline.extract(
            t, arch="drf-level", shape=rec["shape"], mesh_name=rec["mesh"],
            chips=pods * data * model, model_flops_global=8.0 * n * m)
        rec.update(status="ok", memory={"peak_bytes_per_device": float(peak),
                                        "fits": peak <= HBM_BYTES},
                   roofline=terms.row())
        if verbose:
            r = terms.row()
            print(f"OK  drf-level {rec['shape']} {rec['mesh']} "
                  f"mem/dev={peak / 2**30:.3f}GiB "
                  f"compute={r['compute_s'] * 1e3:.3f}ms "
                  f"memory={r['memory_s'] * 1e3:.3f}ms "
                  f"coll={r['collective_s'] * 1e3:.3f}ms "
                  f"coll_bytes={by_axis} dom={r['dominant']} (predicted; "
                  f"sizes, not results)", flush=True)
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"ERR drf-level {e}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--drf", action="store_true", help="also dry-run DRF")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for mp in meshes:
        mesh = production_mesh(mp)
        for a in archs:
            for s in shapes:
                records.append(run_one(a, s, multi_pod=mp, mesh=mesh))
        if args.drf:
            records.append(run_drf(multi_pod=mp))
            mesh = None

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    err = sum(r["status"] == "error" for r in records)
    print(f"\n{ok} ok / {sk} skipped / {err} errors "
          f"of {len(records)} combinations (predicted, not measured)")
    if dist.is_initialized():
        dist.destroy_process_group()
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
