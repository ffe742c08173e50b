"""Sharded LM training on a torch `DeviceMesh` against the reference's
sharded training on a JAX mesh.

One module fixture starts four gloo ranks on the CPU, a ("data", "model")
= (2, 2) mesh (`tests/torch_lm_dist_worker.py port`), beside one JAX
process with four forced host devices that runs the reference's
`train_loop(mesh=make_host_mesh(2, 2))` (`... reference`).  Both train
the reduced qwen3 (dense, GQA, q/k norm) and the reduced olmoe (MoE:
routing per data shard, W = 2, experts over "data") from the
reference's initial state for 1 and for 2 steps at lr 1e-4.

Tolerances are `test_torch_lm_train_archs.py`'s: each step's ce rtol
1e-4; each moment leaf rtol 1e-4 with atol 1e-4 of the leaf's largest
magnitude; each step's parameter update p_t − p_{t−1}, element by
element, within `_update_tolerance` of the two sides' moments.  The
port's sharded dense step is also held to its one-device step, its
sharded checkpoint must restore into a one-device state bit for bit,
and a reduced dense decode of 4 tokens under `DECODE_OVERRIDES` (the
cache's sequence over "model") must give the one-device logits within
1e-4.  RWKV and Mamba run sharded in the dry run's tests only
(`test_torch_dryrun.py`); their sharded training is not held here.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from test_torch_lm_train_archs import _update_tolerance
from torch_lm_dist_worker import ARCHS, DENSE

from repro_torch.optim import adamw

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORKER = TESTS / "torch_lm_dist_worker.py"
WORLD = 4
TIMEOUT = 400
OPT = adamw.AdamWConfig()        # b1, b2, eps: the schedule is not read


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_dist")
    # one intra-op thread a rank: the four ranks and the reference share
    # the test's cores, whether or not pytest runs in workers
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = {"reference": subprocess.Popen(
        [sys.executable, str(WORKER), "reference", str(tmp)], env=ref_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for r in range(WORLD):
        procs[r] = subprocess.Popen(
            [sys.executable, str(WORKER), "port", str(r), str(WORLD),
             str(tmp / "store"), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done = {}
    try:
        for key, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT)
            done[key] = (p.returncode, out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, (rc, out) in done.items():
        assert rc == 0, f"{key} failed:\n{out[-4000:]}"
    return types.SimpleNamespace(
        tmp=tmp, port=json.loads((tmp / "port.json").read_text()))


def _load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _hold(got, want, old_got, old_want, t, lr):
    """`got` and `want` (flat train states after step t) against each
    other: moments rtol 1e-4 / atol 1e-4 of scale, the step's updates
    from each side's own previous state within `_update_tolerance`."""
    assert set(got) == set(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == t
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k == "opt/step":
            continue
        if k.startswith("opt/"):
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"step {t} {k}")
            continue
        key = k[len("params/"):]
        tol = _update_tolerance(
            OPT, t, lr, (want[f"opt/mu/{key}"], want[f"opt/nu/{key}"]),
            (got[f"opt/mu/{key}"], got[f"opt/nu/{key}"]), w)
        gap = np.abs((g.astype(np.float64) - old_got[k])
                     - (w.astype(np.float64) - old_want[k]))
        assert not (gap > tol).any(), (
            f"step {t} {k}: {int((gap > tol).sum())} updates off, the "
            f"worst by {gap.max():.3e}")


LRS = {1: 1e-4, 2: 1e-5}         # the cosine schedule's two steps


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_reference_sharded_steps(runs, arch):
    tmp = runs.tmp
    ref_ce = json.loads((tmp / f"{arch}.json").read_text())
    port_ce = runs.port[f"{arch}.ce"]
    for steps in ("1", "2"):
        np.testing.assert_allclose(port_ce[steps], ref_ce[steps], rtol=1e-4)
    init = _load(tmp / f"{arch}.init.npz")
    init = {k: v.astype(np.float64) for k, v in init.items()}
    r1, r2 = (_load(tmp / f"{arch}.ref{s}.npz") for s in (1, 2))
    p1, p2 = (_load(tmp / f"{arch}.port{s}.npz") for s in (1, 2))
    _hold(p1, r1, init, init, 1, LRS[1])
    _hold(p2, r2, {k: v.astype(np.float64) for k, v in p1.items()},
          {k: v.astype(np.float64) for k, v in r1.items()}, 2, LRS[2])


def test_sharded_dense_step_matches_one_device(runs):
    tmp = runs.tmp
    ce = runs.port[f"{DENSE}.ce"]
    np.testing.assert_allclose(ce["1"], ce["one1"], rtol=1e-4)
    init = {k: v.astype(np.float64)
            for k, v in _load(tmp / f"{DENSE}.init.npz").items()}
    _hold(_load(tmp / f"{DENSE}.port1.npz"), _load(tmp / f"{DENSE}.one1.npz"),
          init, init, 1, LRS[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_checkpoint_restores_bit_for_bit(runs, arch):
    assert runs.port[f"{arch}.restore_bits"] is True


def test_sharded_decode_matches_one_device(runs):
    d = np.load(runs.tmp / "decode.npz")
    assert d["mesh"].shape == d["one"].shape
    np.testing.assert_allclose(d["mesh"], d["one"], rtol=1e-4, atol=1e-4)
    # the cache really is sharded over the batch and its sequence
    assert runs.port["decode_cache_placements"] == \
        "(Shard(dim=1), Shard(dim=2))"
