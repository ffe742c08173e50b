"""Fault tolerance of the port's streamed training: kill it, resume it,
get the same forest.

Ported from the reference's fault suite, with the port on the CPU:
checkpointed fits equal uninterrupted ones on every snapshot cadence;
resuming skips committed tree batches and restarts the batch in flight
at its last snapshot; a resume against another source, params or seed is
refused; transient read faults never change a forest, and a persistent
one writes the held snapshot before `StreamReadError` escapes; atomic
writes keep the old file when the replace window fails; the memmap
cache's sidecar catches a truncated or swapped cache.  SIGKILL (mid-fit,
after a chosen snapshot, inside a snapshot's or a model's atomic write)
runs in a subprocess, and the resume in this process must give the
uninterrupted forest node for node.  One case resumes in the port a
checkpoint that the reference wrote.
"""
import json
import logging
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import atomicio, checkpoint, tree as tree_lib
from repro_torch.core.dataset import (ArrayRowSource, CacheIntegrityError,
                                      MemmapRowSource, StreamReadError)
from repro_torch.core.forest import PackedForest, RandomForest
from repro_torch.data.synthetic import make_tabular
from repro_torch.testing import faults
from repro_torch.testing.faults import FaultyRowSource
from test_torch_harness import reference

SRC = Path(__file__).resolve().parents[1] / "src"
FIELDS = ("feature", "children", "threshold", "is_cat", "cat_mask",
          "value", "n_node", "gain", "depth")


def _forest(params, num_trees=3, seed=7, **kw):
    return RandomForest(params=params, num_trees=num_trees, seed=seed,
                        device="cpu", **kw)


def _assert_forests_identical(fa, fb, ctx=""):
    assert len(fa.trees) == len(fb.trees), ctx
    for t, (ta, tb) in enumerate(zip(fa.trees, fb.trees)):
        assert ta.num_nodes == tb.num_nodes, f"{ctx}/tree{t}: node count"
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f),
                                          err_msg=f"{ctx}/tree{t}: {f}")
    pa, pb = fa._packed_forest(), fb._packed_forest()
    x = np.linspace(-2, 2, 32 * pa.m_num).reshape(32, pa.m_num)
    np.testing.assert_array_equal(
        pa.predict_proba(x, np.zeros((32, 0), np.int32)).numpy(),
        pb.predict_proba(x, np.zeros((32, 0), np.int32)).numpy(),
        err_msg=f"{ctx}: packed predict")


@pytest.fixture(scope="module")
def setup():
    """An uninterrupted streamed fit (pruning on), its source and params."""
    ds = make_tabular("xor", n=600, num_informative=4, num_useless=2,
                      seed=3)
    params = tree_lib.TreeParams(max_depth=5, split_mode="hist",
                                 num_bins=16, prune_closed_frac=0.3)
    src = ArrayRowSource.from_dataset(ds, params.num_bins, chunk_size=149)
    return ds, params, src, _forest(params).fit_streamed(src)


@pytest.fixture(autouse=True)
def _disarm_hooks():
    yield
    faults.disarm()


@pytest.mark.parametrize("every", [1, 2])
def test_checkpointed_fit_parity_and_cadence(setup, tmp_path, every):
    """A checkpointed fit trains the same forest, snapshots on the
    `checkpoint_every` cadence and commits the batch (manifest entry and
    trees file, snapshot dropped, no temporary files left)."""
    _, params, src, ref = setup
    depths = []
    checkpoint.POST_SNAPSHOT_HOOK[0] = lambda depth, path: depths.append(depth)
    ck = tmp_path / f"ck{every}"
    fc = _forest(params).fit_streamed(src, checkpoint_dir=str(ck),
                                      checkpoint_every=every)
    _assert_forests_identical(ref, fc, f"every{every}")
    assert depths and all((d + 1) % every == 0 for d in depths), depths
    with open(ck / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["batches"]["0-2"]["tree_indices"] == [0, 1, 2]
    assert (ck / "trees_0-2.npz").exists()
    assert not (ck / "snap_0-2.npz").exists()
    assert not list(ck.glob("*.tmp.*"))


def test_resume_of_completed_fit_is_a_no_op_reload(setup, tmp_path):
    """resume=True over a committed directory reloads the trees without
    reading the source."""
    _, params, src, ref = setup
    ck = str(tmp_path / "ck")
    _forest(params).fit_streamed(src, checkpoint_dir=ck)
    counter = FaultyRowSource(src)
    fr = _forest(params).fit_streamed(counter, checkpoint_dir=ck,
                                      resume=True)
    assert counter.reads == 0
    _assert_forests_identical(ref, fr, "reload")


@pytest.mark.parametrize("schedule", [{0: 1}, {0: 3, 1: 3, 2: 3},
                                      {7: 2, 13: 1, 19: 3}])
def test_transient_faults_never_change_forest(setup, schedule, caplog):
    _, params, src, ref = setup
    flaky = FaultyRowSource(src, transient=dict(schedule))
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.stream"):
        ff = _forest(params).fit_streamed(flaky)
    _assert_forests_identical(ref, ff, f"transient{schedule}")
    failures = sum(schedule.values())
    assert flaky.attempts == flaky.reads + failures
    assert len([r for r in caplog.records
                if "transient stream read failure" in r.message]) == failures


def test_persistent_fault_flushes_checkpoint_then_escalates(setup, tmp_path):
    """A read failing every retry raises StreamReadError only after the
    held snapshot reached the disk (checkpoint_every=3 would still hold
    it), and the resume finishes the same forest."""
    _, params, src, ref = setup
    ck = str(tmp_path / "ck")
    with pytest.raises(StreamReadError, match="after 4 attempts"):
        _forest(params).fit_streamed(FaultyRowSource(src, persistent={17}),
                                     checkpoint_dir=ck, checkpoint_every=3)
    assert os.path.exists(os.path.join(ck, "snap_0-2.npz"))
    fr = _forest(params).fit_streamed(src, checkpoint_dir=ck, resume=True)
    _assert_forests_identical(ref, fr, "resume-after-dead-read")


def test_resume_skips_completed_tree_batches(tmp_path):
    """A fault in the second tree batch leaves the first committed; the
    resume retrains only the second, from its snapshot."""
    ds = make_tabular("xor", n=400, num_informative=3, num_useless=1,
                      seed=11)
    params = tree_lib.TreeParams(max_depth=4, split_mode="hist",
                                 num_bins=16)
    src = ArrayRowSource.from_dataset(ds, params.num_bins, chunk_size=101)
    ref = _forest(params, 4, 5, tree_batch=2).fit_streamed(src)
    probe = FaultyRowSource(src)
    _forest(params, 2, 5, tree_batch=2).fit_streamed(probe)
    per_batch = probe.reads
    ck = str(tmp_path / "ck")
    chunks_per_level = -(-400 // 101)
    dead = FaultyRowSource(src, persistent={per_batch + chunks_per_level + 1})
    with pytest.raises(StreamReadError):
        _forest(params, 4, 5, tree_batch=2).fit_streamed(
            dead, checkpoint_dir=ck)
    with open(os.path.join(ck, "manifest.json")) as f:
        batches = json.load(f)["batches"]
    assert "0-1" in batches and "2-3" not in batches
    counter = FaultyRowSource(src)
    fr = _forest(params, 4, 5, tree_batch=2).fit_streamed(
        counter, checkpoint_dir=ck, resume=True)
    assert 0 < counter.reads < per_batch
    _assert_forests_identical(ref, fr, "mid-forest-resume")


@pytest.mark.parametrize("other", ["seed", "params", "source"])
def test_resume_fingerprint_mismatch(setup, tmp_path, other):
    _, params, src, _ = setup
    ck = str(tmp_path / "ck")
    _forest(params).fit_streamed(src, checkpoint_dir=ck)
    seed, p, s = 7, params, src
    if other == "seed":
        seed = 8
    elif other == "params":
        p = tree_lib.TreeParams(max_depth=7, split_mode="hist", num_bins=16,
                                prune_closed_frac=0.3)
    else:
        s = ArrayRowSource.from_dataset(
            make_tabular("xor", n=600, num_informative=4, num_useless=2,
                          seed=4), params.num_bins, chunk_size=149)
    with pytest.raises(checkpoint.CheckpointMismatchError, match=other):
        _forest(p, seed=seed).fit_streamed(s, checkpoint_dir=ck,
                                           resume=True)
    # resume=False discards the old state instead
    assert len(_forest(p, seed=seed).fit_streamed(
        s, checkpoint_dir=ck).trees) == 3


def test_resume_true_on_empty_dir_trains_fresh(setup, tmp_path):
    _, params, src, ref = setup
    fr = _forest(params).fit_streamed(
        src, checkpoint_dir=str(tmp_path / "fresh"), resume=True)
    _assert_forests_identical(ref, fr, "fresh-resume")


def test_port_resumes_a_checkpoint_the_reference_wrote(setup, tmp_path):
    """The checkpoint format is the reference's: a reference fit stopped
    by a dead read, resumed by the port, gives the port's forest."""
    ds, params, src, ref = setup
    r = reference()
    from repro.testing.faults import FaultyRowSource as RefFaulty
    rds = r.dataset.from_numpy(ds.num, None, ds.labels)
    rsrc = r.dataset.ArrayRowSource.from_dataset(rds, params.num_bins,
                                                 chunk_size=149)
    ck = str(tmp_path / "ck")
    rp = r.tree.TreeParams(max_depth=5, split_mode="hist", num_bins=16,
                           prune_closed_frac=0.3)
    with pytest.raises(OSError, match="after 4 attempts"):
        r.forest.RandomForest(params=rp, num_trees=3, seed=7).fit_streamed(
            RefFaulty(rsrc, persistent={13}), checkpoint_dir=ck)
    snap = checkpoint.StreamCheckpointer(ck).load_snapshot([0, 1, 2])
    assert snap is not None and int(snap["next_depth"]) >= 1
    fr = _forest(params).fit_streamed(src, checkpoint_dir=ck, resume=True)
    _assert_forests_identical(ref, fr, "reference-checkpoint")


def test_atomic_replace_failure_preserves_target(tmp_path):
    path = str(tmp_path / "f.txt")
    atomicio.atomic_replace(path, lambda t: Path(t).write_text("v1"))

    def exploding_hook(final, tmp):
        raise RuntimeError("crash in the replace window")
    atomicio.PRE_REPLACE_HOOK[0] = exploding_hook
    with pytest.raises(RuntimeError, match="replace window"):
        atomicio.atomic_replace(path, lambda t: Path(t).write_text("v2"))
    assert Path(path).read_text() == "v1"
    assert os.listdir(tmp_path) == ["f.txt"]


def test_packed_forest_save_is_atomic(setup, tmp_path):
    """A failure between the temporary write and the replace leaves the
    previous model loadable."""
    ds, params, _, ref = setup
    path = str(tmp_path / "model.npz")
    ref._packed_forest().save(path)
    other = _forest(params, 2, 1).fit(ds)

    def fail(final, tmp):
        raise OSError("killed mid-save")
    atomicio.PRE_REPLACE_HOOK[0] = fail
    with pytest.raises(OSError, match="mid-save"):
        other._packed_forest().save(path)
    faults.disarm()
    after = PackedForest.load(path, device="cpu")
    assert after.num_trees == 3
    np.testing.assert_array_equal(after.feature.numpy(),
                                  ref._packed_forest().feature.numpy())


def _build_memmap(tmp_path, n=200, m=3, num_bins=16):
    rng = np.random.default_rng(0)
    num = rng.normal(size=(n, m)).astype(np.float32)
    y = (num[:, 0] > 0).astype(np.int32)
    path = str(tmp_path / "bins.npy")
    return MemmapRowSource.from_numpy(num, y, num_bins=num_bins,
                                      path=path), path, y


def test_memmap_build_writes_sidecar_and_opens_clean(tmp_path):
    src, path, _ = _build_memmap(tmp_path)
    with open(MemmapRowSource.meta_path(path)) as f:
        meta = json.load(f)
    assert meta["n"] == 200 and meta["m_num"] == 3
    assert meta["num_bins"] == 16 and meta["dtype"] == "uint8"
    assert src.bins_block(0, 7).shape == (3, 7)


def test_memmap_truncated_cache_raises(tmp_path):
    src, path, y = _build_memmap(tmp_path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 64)
    with pytest.raises(CacheIntegrityError):
        MemmapRowSource(path, src.edges, y, num_classes=2).bins_block(0, 7)


@pytest.mark.parametrize("field,value", [("n", 999),
                                         ("edges_sha256", "0" * 64),
                                         ("dtype", "uint16")])
def test_memmap_sidecar_mismatch_raises(tmp_path, field, value):
    src, path, y = _build_memmap(tmp_path)
    mp = MemmapRowSource.meta_path(path)
    with open(mp) as f:
        meta = json.load(f)
    meta[field] = value
    with open(mp, "w") as f:
        json.dump(meta, f)
    with pytest.raises(CacheIntegrityError, match="sidecar"):
        MemmapRowSource(path, src.edges, y, num_classes=2).bins_block(0, 7)


def test_memmap_legacy_cache_without_sidecar_still_opens(tmp_path, caplog):
    src, path, y = _build_memmap(tmp_path)
    os.unlink(MemmapRowSource.meta_path(path))
    fresh = MemmapRowSource(path, src.edges, y, num_classes=2)
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.stream"):
        assert fresh.bins_block(0, 7).shape == (3, 7)
    assert any("no sidecar" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# SIGKILL -> resume (subprocess on the CPU)
# ---------------------------------------------------------------------------

_SUB_SETUP = """
    import numpy as np
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import ArrayRowSource, MemmapRowSource
    from repro_torch.core.forest import RandomForest
    from repro_torch.data.synthetic import make_tabular
    from repro_torch.testing import faults
    from repro_torch.testing.faults import FaultyRowSource

    ds = make_tabular('xor', n=600, num_informative=4, num_useless=2,
                      seed=3)
    params = tree_lib.TreeParams(max_depth=5, split_mode='hist',
                                 num_bins=16, prune_closed_frac=0.3)
    def forest(**kw):
        return RandomForest(params=params, num_trees=3, seed=7,
                            device='cpu', **kw)
"""


def _run_expect_sigkill(code: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SUB_SETUP)
         + textwrap.dedent(code)], capture_output=True, text=True, env=env,
        timeout=180)
    assert out.returncode == -signal.SIGKILL, (
        f"expected SIGKILL, got rc={out.returncode}\n{out.stderr[-3000:]}")


@pytest.mark.parametrize("backend", ["array", "memmap"])
def test_sigkill_mid_fit_resume_is_bit_identical(setup, tmp_path, backend):
    """SIGKILL at a scheduled chunk read (no cleanup runs); the resume in
    this process grows the uninterrupted forest."""
    ds, params, src, ref = setup
    ck = str(tmp_path / "ck")
    cache = str(tmp_path / "bins.npy")
    _run_expect_sigkill(f"""
        if {backend!r} == 'array':
            src = ArrayRowSource.from_dataset(ds, params.num_bins,
                                              chunk_size=149)
        else:
            src = MemmapRowSource.from_numpy(
                ds.num, ds.labels, num_bins=params.num_bins, path={cache!r},
                chunk_size=149, num_classes=ds.num_classes)
        forest().fit_streamed(FaultyRowSource(src, kill_after_reads=14),
                              checkpoint_dir={ck!r})
        raise SystemExit('unreachable: the kill must fire mid-fit')
    """)
    assert os.path.exists(os.path.join(ck, "snap_0-2.npz"))
    resume_src = src if backend == "array" else MemmapRowSource(
        cache, src.edges, ds.labels, num_classes=ds.num_classes,
        chunk_size=149)
    fr = _forest(params).fit_streamed(resume_src, checkpoint_dir=ck,
                                      resume=True)
    _assert_forests_identical(ref, fr, f"sigkill-{backend}")


def test_sigkill_mid_checkpoint_replace_keeps_previous_snapshot(
        setup, tmp_path):
    """SIGKILL inside the second snapshot's atomic write: the first
    survives and the resume from it grows the same forest."""
    _, params, src, ref = setup
    ck = str(tmp_path / "ck")
    _run_expect_sigkill(f"""
        src = ArrayRowSource.from_dataset(ds, params.num_bins, chunk_size=149)
        faults.arm_kill_mid_replace(nth=2, match='snap_')
        forest().fit_streamed(src, checkpoint_dir={ck!r})
        raise SystemExit('unreachable: the kill must fire mid-write')
    """)
    snap = checkpoint.StreamCheckpointer(ck).load_snapshot([0, 1, 2])
    assert snap is not None and int(snap["next_depth"]) == 1
    fr = _forest(params).fit_streamed(src, checkpoint_dir=ck, resume=True)
    _assert_forests_identical(ref, fr, "sigkill-mid-replace")


def test_sigkill_after_chosen_snapshot_resumes(setup, tmp_path):
    """SIGKILL right after the third snapshot: the resume starts at depth
    3 and replays the rest."""
    _, params, src, ref = setup
    ck = str(tmp_path / "ck")
    _run_expect_sigkill(f"""
        src = ArrayRowSource.from_dataset(ds, params.num_bins, chunk_size=149)
        faults.arm_kill_after_snapshots(nth=3)
        forest().fit_streamed(src, checkpoint_dir={ck!r})
        raise SystemExit('unreachable: the kill must fire at level 3')
    """)
    snap = checkpoint.StreamCheckpointer(ck).load_snapshot([0, 1, 2])
    assert snap is not None and int(snap["next_depth"]) == 3
    fr = _forest(params).fit_streamed(src, checkpoint_dir=ck, resume=True)
    _assert_forests_identical(ref, fr, "sigkill-at-level")


def test_sigkill_mid_model_save_keeps_previous_model(setup, tmp_path):
    """`PackedForest.save` under a real SIGKILL in its replace window: the
    file on disk is the previous complete model."""
    _, _, _, ref = setup
    path = str(tmp_path / "model.npz")
    ref._packed_forest().save(path)
    _run_expect_sigkill(f"""
        other = RandomForest(params=params, num_trees=2, seed=1,
                             device='cpu').fit(ds)
        faults.arm_kill_mid_replace(match='model.npz')
        other._packed_forest().save({path!r})
        raise SystemExit('unreachable: the kill must fire mid-save')
    """)
    loaded = PackedForest.load(path, device="cpu")
    assert loaded.num_trees == 3
    np.testing.assert_array_equal(loaded.feature.numpy(),
                                  ref._packed_forest().feature.numpy())
