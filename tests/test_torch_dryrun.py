"""The dry run (`launch.specs`, `launch.roofline`, `launch.dryrun`)
against the reference's tables and against real one-device counts.

In the test process, with no ranks: `skip_reason`, `moments_dtype_for`,
the active parameter counts and `model_flops` equal the reference's for
every arch × `INPUT_SHAPES` cell.

In one subprocess (a placeholder world must not outlive it): the reduced
qwen3's train step on a fake world of 8 ranks, a (2, 4) mesh, counted by
`StepCounter` — its per-rank FLOPs × 8 must equal `FlopCounterMode` on
the real one-device step (a dense model's products split evenly over
the mesh); the 1-and-2-block extrapolation must equal a count of the
4-block model (FLOPs, bytes and collective bytes exactly, the memory
peak within 1%, since a peak is not additive); the sharded step must
report collective bytes on both axes and a per-rank peak under the
one-device (1, 1) mesh's; and `run_drf` must return "ok" at a small
shape, with collective bytes on both axes.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import base
from repro_torch.launch import dryrun, roofline, specs

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ref():
    from repro.configs import base as rbase
    from repro.launch import roofline as rroof, specs as rspecs
    from repro.models import transformer as rtrans
    return rbase, rroof, rspecs, rtrans


def test_tables_equal_the_references(ref):
    rbase, rroof, rspecs, rtrans = ref
    assert base.INPUT_SHAPES == rbase.INPUT_SHAPES
    assert specs._CACHE_AXES == rspecs._CACHE_AXES
    for arch in base.list_archs():
        cfg, rcfg = base.get_arch(arch), rbase.get_arch(arch)
        assert specs.moments_dtype_for(cfg) == rspecs.moments_dtype_for(rcfg)
        n_act = dryrun.active_params(cfg)
        assert n_act == int(rtrans.active_param_count(
            rspecs.abstract_params(rcfg), rcfg)), arch
        for shape in base.INPUT_SHAPES:
            assert specs.skip_reason(cfg, shape) == \
                rspecs.skip_reason(rcfg, shape)
            assert roofline.model_flops(cfg, shape, n_act) == \
                rroof.model_flops(rcfg, shape, n_act), (arch, shape)


def test_train_cfg_is_the_references_less_unroll(ref):
    _, _, rspecs, _ = ref
    for arch in ("dbrx-132b", "qwen3-0.6b"):
        got = specs.make_train_cfg(base.get_arch(arch), microbatches=2)
        want = rspecs.make_train_cfg(base.get_arch(arch), unroll=False,
                                     microbatches=2)
        assert got.optimizer.moments_dtype == want.optimizer.moments_dtype
        assert (got.remat, got.microbatches) == (want.remat,
                                                 want.microbatches)


def test_roofline_terms_use_the_h100_constants():
    t = roofline.RooflineTerms(
        arch="a", shape="s", mesh="32x8", chips=256,
        flops_per_device=989e12, bytes_per_device=3.35e12 / 2,
        collective_bytes_per_device=0.0, model_flops_global=0.0,
        collectives={"bytes_by_kind": {}, "counts": {}},
        collective_by_axis={"model": 450e9, "data": 50e9})
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(2.0)     # 1 s NVLink + 1 s IB
    assert t.dominant == "collective" and t.bound_s == pytest.approx(2.0)


_SCRIPT = """
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import base
from repro_torch.launch import dryrun, specs
from repro_torch.train import step as train_step
torch.manual_seed(0)
cfg = base.get_arch("qwen3-0.6b").reduced()
B, L = 8, 64
base.INPUT_SHAPES["tiny_train"] = dict(seq_len=L, global_batch=B,
                                       kind="train")
tcfg = specs.make_train_cfg(cfg)
st = train_step.init_train_state(0, cfg, tcfg, device="cpu")
toks = torch.randint(0, cfg.vocab_size, (B, L))
with FlopCounterMode(display=False) as fc:
    train_step.make_train_step(cfg, tcfg)(st, {"inputs": toks,
                                                "labels": toks})
out = {"one_device_flops": fc.get_total_flops()}
one = dryrun.production_mesh(False, shape=(1, 1))
out["one"] = dryrun.count_step(cfg, "tiny_train", one)
mesh = dryrun.production_mesh(False, shape=(2, 4))
out["sharded"] = dryrun.count_step(cfg, "tiny_train", mesh)
c4 = specs.with_blocks(cfg, 4)
out["full4"] = dryrun.count_step(c4, "tiny_train", mesh)
out["ext4"] = dryrun.account(c4, "tiny_train", mesh)
out["cell"] = dryrun.run_one("qwen3-0.6b", "tiny_train", mesh=mesh, cfg=cfg,
                             verbose=False)
out["drf"] = dryrun.run_drf(n=2**12, m=16, num_leaves=15, shape=(2, 4),
                            verbose=False)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    # the fake world of 8 runs in this one subprocess, on a thread count
    # of its own whether or not pytest runs in workers
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SCRIPT), str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


def test_per_rank_flops_times_world_equal_one_device(counted):
    assert counted["sharded"]["flops"] * 8 == counted["one_device_flops"]
    # one rank of a (1, 1) mesh does the whole step, and moves nothing
    assert counted["one"]["flops"] == counted["one_device_flops"]
    assert counted["one"]["wire_bytes"] == 0


def test_block_extrapolation_equals_a_full_count(counted):
    full, ext = counted["full4"], counted["ext4"]
    for k in ("flops", "bytes", "wire_bytes"):
        assert ext[k] == full[k], k
    assert ext["by_axis"] == {a: float(b) for a, b in full["by_axis"].items()}
    np.testing.assert_allclose(ext["peak_bytes"], full["peak_bytes"],
                               rtol=1e-2)


def test_sharded_cell_moves_bytes_and_holds_less(counted):
    cell = counted["cell"]
    assert cell["status"] == "ok" and cell["predicted"] is True
    r = cell["roofline"]
    assert r["coll_bytes_by_axis"]["data"] > 0
    assert r["coll_bytes_by_axis"]["model"] > 0
    assert r["flops_per_dev"] * 8 == counted["one_device_flops"]
    assert cell["memory"]["peak_bytes_per_device"] \
        < counted["one"]["peak_bytes"]
    assert cell["memory"]["fits"]


def test_run_drf_small(counted):
    d = counted["drf"]
    assert d["status"] == "ok", d.get("error")
    assert d["predicted"] is True
    assert d["roofline"]["coll_bytes_by_axis"]["data"] > 0
    assert d["roofline"]["coll_bytes_by_axis"]["model"] > 0
