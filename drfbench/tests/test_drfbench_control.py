"""The control and the planted faults come out as not correct.

On the CPU, at a size a test run holds: the reference grown in bfloat16
(the precision below the configuration's float32) fails the limits of
every cell (the program's own readings pass them: the harness and
reference tests), and a whole run of each cell with its timed path broken
underneath reads `correct: false` for each fault a one-chip fit can have:
a level step that returns its state unchanged, half of the rows left out
of the bag, and an answer (a node's class distribution) altered where it
is produced.  The card leg repeats the control at 2^18 rows."""
import contextlib
import json

import pytest
import torch

from drfbench import control, harness
from drfbench.tests.tiny import CELLS, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def _over(r: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if r[k] > lim]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails(root, cell):
    limits = harness.load_cell(cell, root).limits
    for seed in (1, 2, 3):
        assert _over(control.readings(cell, seed, True, "cpu", root),
                     limits), seed


def _state_unchanged(monkeypatch, cell):
    from repro_torch.core import tree
    from repro_torch.core.level import plan
    if cell.endswith("streamed"):       # the chunk step's reassignment
        monkeypatch.setattr(plan, "_reassign", lambda leaf_of, *a: leaf_of)
        return
    step = tree._fused_level_step_batched

    def unchanged(inp, *a, **kw):
        struct, _, totals, tables, _ = step(inp, *a, **kw)
        return struct, inp.leaf_of, totals, tables, inp.ord_idx
    monkeypatch.setattr(tree, "_fused_level_step_batched", unchanged)


def _half_the_rows(monkeypatch, cell):
    from repro_torch.core import bagging
    counts = bagging.bag_counts_forest

    def half(seed, tidx, n, mode="poisson", device=None):
        w = counts(seed, tidx, n, mode, device)
        w[:, n // 2:] = 0
        return w
    monkeypatch.setattr(bagging, "bag_counts_forest", half)


def _answer_altered(monkeypatch, cell):
    from repro_torch.core import tree
    set_value = tree._NodeAccum.set_value

    def altered(self, node, row, count, task):
        set_value(self, node, row, count, task)
        self.value[node] = self.value[node] + 1e-3
    monkeypatch.setattr(tree._NodeAccum, "set_value", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_rows,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(root, cell, fault,
                                               monkeypatch):
    fault(monkeypatch, cell)
    out = harness.run_cell(cell, 2**31 + 3, 0.01, False, device="cpu",
                           root=root)
    assert out["correct"] is False and out["failed"] >= 1
    json.dumps(out)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda, tmp_path, cell):
    root = make_root(tmp_path, rows=1 << 18)
    limits = harness.load_cell(cell, root).limits
    for seed in (1, 2, 3):
        assert _over(control.readings(cell, seed, True, cuda, root), limits)
        assert not _over(control.readings(cell, seed, False, cuda, root),
                         limits)
