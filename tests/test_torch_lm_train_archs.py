"""Every registered architecture's reduced variant trained two steps by the
port and by the reference on the CPU, from the same weights (the
reference's `init_train_state(PRNGKey(0))`, carried across by
`checkpoint.io.from_reference_state`) and the same batches, each step
from the reference's state: the metrics (`loss`, `ce`, `aux`,
`grad_norm`, `lr`) of both steps, and after each step every parameter's
update, every `mu` and `nu` leaf.  Also `microbatches=2` against the
reference, for a dense and an MoE model.

Tolerances (float32 throughout; lr 1e-4 with no warmup, so that a step
moves each parameter by ~1e-4, far above the update tolerance): metrics
rtol 1e-4.  Each step's parameter update p_new − p_old against the
reference's, element by element, within the gap that the two sides'
moments allow (`_update_tolerance`: ~1e-6 of lr where they agree; it
opens up only where a gradient element lies within rounding of zero, so
that the direction of its step is noise).  Each moment leaf rtol 1e-4
with atol 1e-4 of the leaf's largest magnitude (the leaves' scales
differ by orders of magnitude, and the RWKV recurrence's exponentials
carry its forward's float32 rounding, ~1e-7, into the gradients at
~5e-5 of their scale).  Why lr 1e-4 and not 1e-3: one lr-1e-3 step
from init takes the reduced RWKV to a state where its float32
gradients move by ~1e-4 of their scale with the rounding of the
time-mix projections alone, in the reference too
(`tests/rwkv_train_precision.py` measures it against float64), so a
second step there would compare roundings, not implementations.
"""
import numpy as np
import pytest
import torch

from test_torch_harness import reference_lm

from repro_torch.checkpoint import io
from repro_torch.configs import base
from repro_torch.optim import adamw
from repro_torch.train import step as tstep

ARCHS = ["chatglm3-6b", "dbrx-132b", "granite-3-2b", "jamba-1.5-large-398b",
         "llama3-8b", "llama3-8b-sw8k", "llava-next-mistral-7b",
         "musicgen-medium", "olmoe-1b-7b", "qwen3-0.6b", "rwkv6-7b"]
S = 16


@pytest.fixture(scope="module")
def ref():
    return reference_lm()


def _batch(cfg, B, rng):
    """(the reference's numpy batch, the port's torch batch)."""
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        xt = torch.from_numpy(x.astype(np.int64))
    else:
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        xt = torch.from_numpy(x)
    y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"inputs": x, "labels": y},
            {"inputs": xt, "labels": torch.from_numpy(y.astype(np.int64))})


def _update_tolerance(ocfg, t, lr, want, got, p_new):
    """How far the port's step-`t` update of one leaf may lie from the
    reference's, element by element, from the same parameters.  `want`,
    `got`: each side's (mu, nu) after the step.  With r = m̂/(√v̂ + eps)
    the update is lr·(r + wd·p_old), and the gap between two updates is
    bounded exactly by lr·(|m̂ − m̂'|/(√v̂' + eps)
    + |m̂|·|1/(√v̂ + eps) − 1/(√v̂' + eps)|) from the two sides' own
    moments, plus float32 rounding (1e-6 of the update, 2⁻²² of the
    parameter).  Where the moments agree this is ~1e-6 of lr; it only
    opens up where a gradient element is within the two sides' rounding
    of zero, so that the direction of its step is noise."""
    c1, c2 = 1 - ocfg.b1 ** t, 1 - ocfg.b2 ** t
    (mw, vw), (mg, vg) = ([np.asarray(a, np.float64) for a in side]
                          for side in (want, got))
    mw, mg = mw / c1, mg / c1
    aw, ag = np.sqrt(vw / c2) + ocfg.eps, np.sqrt(vg / c2) + ocfg.eps
    gap = np.abs(mw - mg) / ag + np.abs(mw) * np.abs(1 / aw - 1 / ag)
    return (lr * (gap + 1e-6 * (1 + np.abs(mw / aw)))
            + 2.0 ** -22 * np.abs(p_new))


def _train_both(ref, arch, B=2, steps=2, **tkw):
    """`steps` steps at lr 1e-4 with no warmup, so that each parameter
    moves ~1e-4 a step.  Each step starts both sides from the reference's
    state (the port's is rebuilt from it by `from_reference_state`), so
    that no step inherits the last one's rounding: a parameter whose
    gradient lies within rounding of zero may step either way, and at
    this lr that would reach the next step's gradients.  After each step:
    the metrics; every moment leaf; and the update p_new − p_old of every
    parameter element, against the reference's within
    `_update_tolerance`.  The elements whose tolerance exceeds lr/2 (the
    direction of their step unpinned) are counted and printed."""
    jax = ref.jax
    rc = ref.configs.get_arch(arch).reduced()
    pc = base.get_arch(arch).reduced()
    opt = dict(lr=1e-4, warmup_steps=1)
    rt = ref.train_step.TrainConfig(
        ce_chunks=4, optimizer=ref.adamw.AdamWConfig(**opt), **tkw)
    pt = tstep.TrainConfig(ce_chunks=4, optimizer=adamw.AdamWConfig(**opt),
                           **tkw)
    rstate = jax.jit(ref.train_step.init_train_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), rc, rt)          # one compile, not one an op
    rstep = jax.jit(ref.train_step.make_train_step(rc, rt))
    pstep = tstep.make_train_step(pc, pt)
    rng = np.random.default_rng(1)
    loose = total = 0
    for t in range(1, steps + 1):
        old = jax.tree_util.tree_map(np.asarray, rstate)
        pstate = io.from_reference_state(old, pc, pt, device="cpu")
        old = io._flatten(old)
        rb, pb = _batch(rc, B, rng)
        rstate, rm = rstep(rstate, rb)
        pstate, pm = pstep(pstate, pb)
        assert set(pm) == set(rm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        lr = float(rm["lr"])
        assert lr > 9e-5
        want = io._flatten(jax.tree_util.tree_map(np.asarray, rstate))
        got = {k: v.numpy() for k, v in io.flatten_state(pstate).items()}
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if k == "opt/step":
                assert int(g) == int(w) == t
            elif k.startswith("opt/"):
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                    err_msg=f"step {t} {k}")
            else:
                key = k[len("params/"):]
                tol = _update_tolerance(
                    pt.optimizer, t, lr,
                    (want[f"opt/mu/{key}"], want[f"opt/nu/{key}"]),
                    (got[f"opt/mu/{key}"], got[f"opt/nu/{key}"]), w)
                gap = np.abs((g.astype(np.float64) - old[k])
                             - (w.astype(np.float64) - old[k]))
                bad = gap > tol
                assert not bad.any(), (
                    f"step {t} {k}: {int(bad.sum())} updates off the "
                    f"reference's, the worst by {gap.max():.3e} (lr "
                    f"{lr:.3e})")
                loose += int((tol > lr / 2).sum())
                total += tol.size
    print(f"{arch}: {loose} of {total} element updates with a tolerance "
          f"over lr/2")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(ref, arch):
    _train_both(ref, arch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_microbatches_match_reference(ref, arch):
    """k = 2 microbatches of 2: gradients summed in the parameters' dtype,
    then divided by k; MoE capacity per microbatch."""
    _train_both(ref, arch, B=4, microbatches=2)


def test_microbatches_equal_whole_batch_for_a_dense_model():
    """A dense model's mean CE over two halves equals the whole batch's,
    so k = 2 and k = 1 give the same step up to float32 rounding."""
    cfg = base.get_arch("qwen3-0.6b").reduced()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, S)))
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, S)))
    out = []
    for k in (1, 2):
        tcfg = tstep.TrainConfig(microbatches=k, optimizer=adamw.AdamWConfig(
            lr=1e-3, warmup_steps=1))
        st = tstep.init_train_state(0, cfg, tcfg, device="cpu")
        st, m = tstep.make_train_step(cfg, tcfg)(st, {"inputs": x,
                                                      "labels": y})
        out.append((m, st["opt"]["mu"]))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(out[0][0][key]),
                                   float(out[1][0][key]), rtol=1e-5)
    for a, b in zip(adamw.leaves(out[0][1]), adamw.leaves(out[1][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
