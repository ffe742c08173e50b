"""Reference harness for the PyTorch port's parity tests, plus the port's
package rules checked in subprocesses.

`reference()` imports the JAX package `repro` — the oracle every port
module is held against — under a shim for jax 0.9, whose
`PrimitiveBatchersProxy` supports no `in` test (`repro/core/splits.py`
runs one at import).  The shim is applied only when a test body calls
`reference()`, never at module import: collection runs before any test,
so the JAX suite's own files collect exactly as they would without the
port's tests.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def _apply_shim() -> None:
    from jax._src.interpreters import batching
    proxy = batching.primitive_batchers
    try:
        None in proxy                                   # noqa: B015
    except TypeError:
        type(proxy).__contains__ = (
            lambda self, k: k in batching.fancy_primitive_batchers)


def reference() -> types.SimpleNamespace:
    """The reference package's modules, imported under the jax-0.9 shim."""
    _apply_shim()
    import jax
    import jax.numpy as jnp
    from repro.core import (bagging, dataset, forest, gbt, presort, splits,
                            tree)
    from repro.data import synthetic
    from repro.kernels import cat_hist, ops, ref, split_scan
    from repro.serve import engine as serve_engine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, bagging=bagging, dataset=dataset, forest=forest,
        gbt=gbt, presort=presort, splits=splits, tree=tree,
        synthetic=synthetic, cat_hist=cat_hist, ops=ops, ref=ref,
        split_scan=split_scan, serve_engine=serve_engine)


def reference_lm() -> types.SimpleNamespace:
    """The reference's LM scaffold: configs, models, the LM server, the
    checkpoint io, the optimizer, the train step, the token stream and
    the serving and training entry points.  None of them reaches
    `repro.core.splits`, so no shim is needed."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import io
    from repro.configs import base as configs
    from repro.data import synthetic
    from repro.launch import serve as launch_serve
    from repro.launch import train as launch_train
    from repro.models import layers, mamba, moe, rwkv, transformer
    from repro.optim import adamw
    from repro.serve import engine
    from repro.train import step as train_step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, io=io, configs=configs, synthetic=synthetic,
        launch_serve=launch_serve, launch_train=launch_train,
        layers=layers, mamba=mamba, moe=moe, rwkv=rwkv,
        transformer=transformer, engine=engine, adamw=adamw,
        train_step=train_step)


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_port_modules_never_import_jax_or_reference():
    r = _run("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        assert len(names) >= 15, names
        expected = {"repro_torch.launch.mesh",
                    "repro_torch.launch.multihost_smoke",
                    "repro_torch.launch.serve",
                    "repro_torch.configs.base",
                    "repro_torch.configs.qwen3_0_6b",
                    "repro_torch.models.transformer",
                    "repro_torch.models.moe",
                    "repro_torch.models.rwkv",
                    "repro_torch.models.mamba",
                    "repro_torch.checkpoint.io",
                    "repro_torch.data.synthetic",
                    "repro_torch.optim.adamw",
                    "repro_torch.train.step",
                    "repro_torch.launch.train",
                    "repro_torch.train.sharding",
                    "repro_torch.launch.specs",
                    "repro_torch.launch.roofline",
                    "repro_torch.launch.dryrun"}
        assert expected <= set(names), sorted(expected - set(names))
        # importing the dry run starts no process group (its placeholder
        # world is made when it runs)
        import torch.distributed as dist
        assert not dist.is_initialized()
        from repro_torch.configs.base import list_archs
        assert len(list_archs()) == 11, list_archs()
        print(len(names))
    """)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_never_imports_jax_or_reference():
    r = _run(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
        assert not bad, bad
    """)
    assert r.returncode == 0, r.stderr


def test_fit_without_device_raises_without_cuda():
    r = _run("""
        import numpy as np
        from repro_torch.core.dataset import from_numpy
        from repro_torch.core.forest import RandomForest
        from repro_torch.core.tree import TreeParams
        rng = np.random.default_rng(0)
        ds = from_numpy(rng.normal(size=(50, 2)).astype(np.float32), None,
                        (rng.random(50) > 0.5).astype(np.int32))
        try:
            RandomForest(TreeParams(backend="kernel"), num_trees=1).fit(ds)
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("raised")
        else:
            raise SystemExit("fit ran without a GPU")
    """, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr
    assert "raised" in r.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """No card, or no repository beside it: non-zero exit, no result."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, cwd=tmp_path, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_reference_harness_loads_the_oracle():
    ref = reference()
    w = np.asarray(ref.bagging.bag_counts(3, 1, 64))
    assert w.shape == (64,) and (w >= 0).all()
