"""The port's multi-process smoke run (`repro_torch.launch.multihost_smoke`)
on the CPU: N gloo processes, one (data=N, model=1) mesh spanning all of
them, the sharded-hist forest equal in every process to its one-process
fit.  gloo crosses processes on the CPU, so the run is the reference's
`global` mode."""
import pytest

from repro_torch.launch import multihost_smoke


@pytest.mark.parametrize("nproc", [2, 4])
def test_multihost_smoke_runs_one_global_mesh(nproc, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # one thread a worker
    out = multihost_smoke.main(nproc, timeout=240.0, device="cpu")
    assert out == {"nproc": nproc, "mode": "global", "fingerprints": 1}
    assert f"{nproc} processes OK, mode=global" in capsys.readouterr().out


def test_multihost_smoke_runs_on_the_card_by_default(monkeypatch):
    """Like every entry point, the smoke run resolves no device to the
    card: without one it raises before it starts a worker."""
    import subprocess
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="runs on CUDA by default"):
        multihost_smoke.main(2)
    assert spawned == []


def test_multihost_smoke_fingerprint_is_the_trees():
    """The fingerprint reads every tree array: two forests that differ in
    one node differ in it."""
    import numpy as np
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import RandomForest
    rng = np.random.default_rng(0)
    num = rng.normal(size=(200, 3)).astype(np.float32)
    y = ((num[:, 0] + num[:, 1] * num[:, 2]) > 0).astype(np.int32)
    fit = lambda seed: RandomForest(  # noqa: E731
        tree_lib.TreeParams(max_depth=4), num_trees=2, seed=seed,
        device="cpu").fit(from_numpy(num, None, y))
    fa = multihost_smoke._forest_fingerprint(fit(0))
    assert fa == multihost_smoke._forest_fingerprint(fit(0))
    assert fa != multihost_smoke._forest_fingerprint(fit(1))
