"""How far the reduced rwkv6-7b's float32 training gradients lie from
float64, in the reference and in the port, at the state one AdamW step
from init (lr 1e-4 and lr 1e-3, no warmup).  Not a test: a measurement.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv_train_precision.py

For each lr it prints, per variant, the worst gap to the port run in
float64, relative to each gradient leaf's largest element:
  ref32       the reference (jax, float32);
  port32      the port (float32);
  port32-mix  the port with the time-mix projections of
              `rwkv._mix_inputs` accumulated in float64 and rounded once;
and the leaf where the gap is worst.  The float64 port is the port with
`torch.float32` and `Tensor.float` pointed at float64 in this process.
"""
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_harness import reference_lm  # noqa: E402

from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH, B, S = "rwkv6-7b", 2, 16


def batch(cfg, rng):
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"inputs": x, "labels": y},
            {"inputs": torch.from_numpy(x.astype(np.int64)),
             "labels": torch.from_numpy(y.astype(np.int64))})


def mix_inputs_rounded_once(p, x, xx):
    """`rwkv._mix_inputs` with each projection accumulated in float64."""
    mm = lambda a, b: (a.double() @ b.double()).float()
    mu = p["mu"][:, None, None, :]
    xr, xk, xv, xg, xw = x[None] + (xx - x)[None] * mu
    wd = p["wr"].dtype
    r, k, v = (mm(a.to(wd), p[n]) for a, n in ((xr, "wr"), (xk, "wk_r"),
                                               (xv, "wv_r")))
    g = F.silu(mm(xg.to(wd), p["wg"]))
    ww = p["w0"] + mm(torch.tanh(mm(xw.float(), p["wA"])), p["wB"])
    return r, k, v, g, -torch.exp(ww)


def port_grads(params, cfg, pb, wide=False):
    model = io.from_reference_params(params, cfg, device="cpu")
    if wide:
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.double()
    model.requires_grad_(True)
    loss, _ = tstep.make_loss_fn(cfg, tstep.TrainConfig(ce_chunks=4))(
        model, pb)
    loss.backward()
    return {n.replace(".", "/"): p.grad.double().numpy()
            for n, p in model.params.named_parameters()}


def main():
    ref = reference_lm()
    jax = ref.jax
    rc = ref.configs.get_arch(ARCH).reduced()
    pc = base.get_arch(ARCH).reduced()
    for lr in (1e-4, 1e-3):
        rt = ref.train_step.TrainConfig(
            ce_chunks=4, optimizer=ref.adamw.AdamWConfig(lr=lr,
                                                         warmup_steps=1))
        state = jax.jit(ref.train_step.init_train_state,
                        static_argnums=(1, 2))(jax.random.PRNGKey(0), rc, rt)
        rng = np.random.default_rng(1)
        rb, _ = batch(rc, rng)
        state, _ = jax.jit(ref.train_step.make_train_step(rc, rt))(state, rb)
        rb, pb = batch(rc, rng)
        params = jax.tree_util.tree_map(np.asarray, state["params"])
        loss_fn = ref.train_step.make_loss_fn(rc, rt)
        got = {"ref32": io._flatten(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(
                state["params"], rb)))}
        got["port32"] = port_grads(params, pc, pb)
        plain = rwkv._mix_inputs
        rwkv._mix_inputs = mix_inputs_rounded_once
        try:
            got["port32-mix"] = port_grads(params, pc, pb)
        finally:
            rwkv._mix_inputs = plain
        f32, tf = torch.float32, torch.Tensor.float
        torch.float32, torch.Tensor.float = torch.float64, torch.Tensor.double
        try:
            wide = port_grads(params, pc, pb, wide=True)
        finally:
            torch.float32, torch.Tensor.float = f32, tf
        for name, g in got.items():
            gaps = {k: float(np.abs(g[k] - w).max() / np.abs(w).max())
                    for k, w in wide.items()}
            k = max(gaps, key=gaps.get)
            print(f"lr {lr:.0e}  {name:10s} worst gap to float64 "
                  f"{gaps[k]:.2e} of the leaf's largest ({k})")


if __name__ == "__main__":
    main()
