"""End-to-end LM training driver, ported from `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --steps 200 --batch 8 --seq 128 --device cpu

Runs on the card unless `--device cpu` is given, on one device (the
reference's `mesh=None` path).  `--smoke` trains the architecture's
reduced (2-layer, float32) variant.  Weights are drawn from `--seed` on
the device; batches come from `TokenStream` and equal the reference's.
Prints the reference's lines, ending with the `ce first10/last10` line.

On a mesh, `train_loop(cfg, ..., mesh=mesh)` is called in every rank of
an initialized `torch.distributed` group with the same arguments, `mesh`
a `DeviceMesh` with axes ("data", "model") or ("pod", "data", "model")
(`launch.mesh.make_host_mesh` / `make_production_mesh`): the train
state is laid out by the sharding rules (`train.step.shard_state`), each
batch is sharded by the `batch` rule, and every step runs inside
`train.sharding.use_mesh_rules`, as the reference's jit does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs.base import get_arch
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import sharding as shd
from repro_torch.train import step as train_step_lib


def to_batch(raw: dict, device, mesh=None) -> dict:
    """A `TokenStream` batch (int32 numpy) as int64 tensors on `device`;
    on a mesh, DTensors sharded by the `batch` rule (every rank makes the
    same full batch and keeps its own rows)."""
    out = {k: torch.from_numpy(raw[k].astype(np.int64)).to(device)
           for k in ("inputs", "labels")}
    if mesh is None:
        return out
    rules = shd.make_rules(mesh)
    return {k: shd.distribute(v, mesh, shd.placements(shd.logical_spec(
        ("batch", "seq"), mesh, rules, v.shape), mesh))
        for k, v in out.items()}


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _printer(mesh):
    """print, on one rank of a mesh (rank 0) or everywhere off it."""
    quiet = mesh is not None and torch.distributed.get_rank() != 0
    return (lambda msg: None) if quiet else \
        (lambda msg: print(msg, flush=True))


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               seed: int = 0, log_every: int = 10, mesh=None,
               checkpoint_path: str | None = None, ce_chunks: int = 4,
               device=None, state=None):
    """Train `cfg` for `steps` AdamW steps (warmup a tenth of them, cosine
    to the end) on `TokenStream(vocab, seq, batch, seed)`.  Returns (the
    train state, the per-step `ce` floats).

    `state`: a one-device train state to start from (default: weights
    drawn from `seed`, zero moments).  `mesh`: a `DeviceMesh`; the state
    is then sharded on it and `device` is the mesh's.  A checkpoint of a
    sharded state is gathered and written once, in the reference's
    format."""
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    tcfg = train_step_lib.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                    total_steps=steps),
        ce_chunks=ce_chunks)
    if state is None:
        state = train_step_lib.init_train_state(seed, cfg, tcfg, device=dev)
    n_params = transformer.param_count(state["model"])
    if mesh is not None:
        state = train_step_lib.shard_state(state, mesh)
    say = _printer(mesh)
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={steps} "
        f"batch={batch} seq={seq}")

    step_fn = train_step_lib.make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size, seq, batch, seed)
    losses = []
    t0 = time.time()
    for i, raw in zip(range(steps), stream):
        if mesh is None:
            state, m = step_fn(state, to_batch(raw, dev))
        else:
            with shd.use_mesh_rules(mesh):
                state, m = step_fn(state, to_batch(raw, dev, mesh))
        m = {k: train_step_lib.scalar(v) for k, v in m.items()}
        losses.append(m["ce"])
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            say(f"step {i:5d}  ce={losses[-1]:.4f}  "
                f"aux={m['aux']:.4f}  "
                f"gnorm={m['grad_norm']:.2f}  "
                f"lr={m['lr']:.2e}  {dt:.1f}s")
    if checkpoint_path:
        ckpt_io.save_state(checkpoint_path, state)
        say(f"checkpoint -> {checkpoint_path}")
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr,
                           checkpoint_path=args.checkpoint,
                           device=args.device)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"ce first10={first:.4f} last10={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
