"""End-to-end LM training driver, ported from `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      --smoke --steps 200 --batch 8 --seq 128 --device cpu

Runs on the card unless `--device cpu` is given, on one device (the
reference's `mesh=None` path).  `--smoke` trains the architecture's
reduced (2-layer, float32) variant.  Weights are drawn from `--seed` on
the device; batches come from `TokenStream` and equal the reference's.
Prints the reference's lines, ending with the `ce first10/last10` line.
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
from repro_torch.train import step as train_step_lib


def to_batch(raw: dict, device) -> dict:
    """A `TokenStream` batch (int32 numpy) as int64 tensors on `device`."""
    return {k: torch.from_numpy(raw[k].astype(np.int64)).to(device)
            for k in ("inputs", "labels")}


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               seed: int = 0, log_every: int = 10,
               checkpoint_path: str | None = None, ce_chunks: int = 4,
               device=None):
    """Train `cfg` for `steps` AdamW steps (warmup a tenth of them, cosine
    to the end) on `TokenStream(vocab, seq, batch, seed)`.  Returns (the
    train state, the per-step `ce` floats)."""
    dev = resolve_device(device)
    tcfg = train_step_lib.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                                    total_steps=steps),
        ce_chunks=ce_chunks)
    state = train_step_lib.init_train_state(seed, cfg, tcfg, device=dev)
    n_params = transformer.param_count(state["model"])
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={steps} "
          f"batch={batch} seq={seq}", flush=True)

    step_fn = train_step_lib.make_train_step(cfg, tcfg)
    stream = TokenStream(cfg.vocab_size, seq, batch, seed)
    losses = []
    t0 = time.time()
    for i, raw in zip(range(steps), stream):
        state, m = step_fn(state, to_batch(raw, dev))
        losses.append(float(m["ce"]))
        if i % log_every == 0 or i == steps - 1:
            dt = time.time() - t0
            print(f"step {i:5d}  ce={losses[-1]:.4f}  "
                  f"aux={float(m['aux']):.4f}  "
                  f"gnorm={float(m['grad_norm']):.2f}  "
                  f"lr={float(m['lr']):.2e}  {dt:.1f}s", flush=True)
    if checkpoint_path:
        ckpt_io.save_state(checkpoint_path, state)
        print(f"checkpoint -> {checkpoint_path}", flush=True)
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
