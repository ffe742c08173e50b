"""Mesh-sharded SplitEngines over `torch.distributed`, ported from
`repro.core.level.sharded`.

Topology (the paper's worker layout, as the reference maps it):

  * `feature_axis` ("model") = the splitters: the feature columns are
    sharded over it, each rank searching splits only on its own columns.
  * `row_axis` ("data") = row shards.  For the exact engine these are
    range partitions of the PRESORTED order: shard r of a column holds
    sorted positions [r·n/R, (r+1)·n/R), and each shard resumes the scan
    from the state the shards before it leave (an all_gather of (L+1)·(S+1)
    numbers per column and tree, whatever n is).  For the histogram and
    categorical engines rows shard in plain row order, and one all-reduce
    a level merges the fixed-size tables: the paper's network contrast,
    both executable.

The reference runs these as `shard_map` programs over a
`jax.sharding.Mesh`.  Here each device of the mesh is one process
(`launch.mesh.Mesh`), and every rank runs the same host driver and level
plan on the replicated class list (`leaf_of`, `w`, `stats`, totals): "Sliq/R
and DRF duplicate the class list in each worker".  An engine slices its
rank's shard of the level inputs itself, as `shard_map`'s in_specs did,
and merges with explicit collectives, so that every rank ends the level
with the same (T, m, L+1) gains and thresholds (masks) and grows the same
trees, which equal the one-device trees.  The tables come through the
`feat_hist` and `cat_hist` kernel wrappers, as the local engines'.

Regression tables are not float sums: the kernels sum them in 64-bit
fixed point with scales picked from the rows they are given.  Row shards
therefore share the scales of the whole row set (the global n and an
all-reduce max of the shards' magnitudes), add their int64 sums over
`data`, and convert once, which gives the one-device table bit for bit.
Classification category tables are int32 class counts, as the local
engine's, and hist tables float32 counts; each is reduced as it is.  The
hist tables and the exact engine's float32 prefixes are exact only below
2^24, so a mesh fit refuses a tree whose in-bag weight reaches it
(`LevelPlan.count_limit`: no mesh engine sets `exact_counts`).

An engine needs a `Mesh`: without one, or for column or row counts that
its axes do not divide, it raises (`shard_map` refuses those shapes).
Engines keep the reference's legacy `__call__` signatures where it had
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core import splits
from repro_torch.core.level.engines import (LevelStatics, SplitEngine,
                                            _column_chunk, _expand_subtracted,
                                            _hist_build_rows, _score_tables)
from repro_torch.kernels import cat_hist
from repro_torch.kernels import ops as kops

NUMERIC_BACKENDS = ("segment", "scan")


@dataclasses.dataclass(frozen=True)
class _MeshEngine(SplitEngine):
    mesh: object = None         # launch.mesh.Mesh (hashed by identity)
    feature_axis: str = "model"
    row_axis: Optional[str] = "data"

    def __post_init__(self):
        if self.mesh is None:
            raise RuntimeError(
                f"{type(self).__name__} needs a launch.mesh.Mesh over an "
                f"initialized torch.distributed group (make_mesh)")

    def row_shards(self) -> int:
        if self.row_axis is None:
            return 1
        return self.mesh.axis_size(self.row_axis)

    def _cols(self, m: int, what: str) -> slice:
        return self.mesh.shard(m, self.feature_axis, what)

    def _rows(self, n: int, what: str = "n (rows)") -> slice:
        if self.row_axis is None:
            return slice(None)
        return self.mesh.shard(n, self.row_axis, what)

    def _row_reduce(self, x, op="sum"):
        if self.row_axis is None:
            return x
        return self.mesh.all_reduce(x, self.row_axis, op)

    def _gather_cols(self, x):
        """(T, m_loc, ...) per rank -> (T, m, ...), columns in mesh order."""
        g = self.mesh.all_gather(x, self.feature_axis)   # (F, T, m_loc, ...)
        F, T = g.shape[:2]
        return g.transpose(0, 1).reshape((T, F * g.shape[2]) + g.shape[3:])

    def _merged_tables(self, build, leaf, w, y, L1, task, n):
        """The tables `build(**kw)` makes from this rank's rows, summed
        over the row shards.  Regression: one set of fixed-point scales for
        all n rows (an all-reduce max of each shard's magnitudes), the
        shards' int64 sums added, one conversion."""
        if task != "regression":
            return self._row_reduce(build())
        mags = self._row_reduce(cat_hist.fixed_point_mags(
            leaf, w, y.to(torch.float32), L1), "max")
        scales = cat_hist.power_of_two_scales(mags.tolist(), n)
        acc = self._row_reduce(build(scales=scales, fixed=True))
        return cat_hist.from_fixed_point(acc, scales)


def _labels_from_stats(stats, w, task):
    """Row labels behind legacy row stats (w·onehot(y), or w·[1, y, y²]):
    exact for classification; y = wy / w for regression (exact for the
    weights 0 and 1 that GBT and unbagged fits use)."""
    if task == "classification":
        return stats.argmax(-1).to(torch.float32)
    return torch.where(w > 0, stats[..., 1] / w.clamp(min=1e-30), 0.0)


# ---------------------------------------------------------------------------
# Exact numeric engine: columns over "model", presorted rows over "data"
# ---------------------------------------------------------------------------

def _shard_state(vals, lf, ww, stt, L1):
    """Per (column, leaf) of one row shard: the in-bag stat totals
    (float64) and the last in-bag value, packed as (mc, L1, S+1) float64
    (the value in the last channel; −inf where the leaf has none).

    The rows are grouped by leaf with a stable sort and reduced per block
    by 1-D `torch.segment_reduce` calls, one per channel: a few hundred
    cells would take millions of contended atomic adds, the block sums
    are the same bits on every run, and on CUDA a 1-D reduce spreads each
    block over a thread block, where a 2-D one loops over it in one
    thread."""
    mc, n = lf.shape
    S = stt.shape[-1]
    dev = lf.device
    order = torch.sort(lf, dim=1, stable=True).indices
    lf_s = torch.gather(lf, 1, order).long()
    inb = torch.gather((ww > 0) & (lf > 0), 1, order)
    contrib = torch.where(inb[..., None], torch.gather(
        stt, 1, order[..., None].expand(mc, n, S)), 0.0).double()
    lengths = torch.bincount(
        (lf_s + torch.arange(mc, device=dev)[:, None] * L1).reshape(-1),
        minlength=mc * L1)
    out = torch.empty((mc * L1, S + 1), dtype=torch.float64, device=dev)
    for c in range(S):
        out[:, c] = torch.segment_reduce(contrib[..., c].reshape(-1), "sum",
                                         lengths=lengths, unsafe=True,
                                         initial=0.0)
    out[:, S] = torch.segment_reduce(
        torch.where(inb, torch.gather(vals, 1, order), splits.NEG
                    ).reshape(-1).double(), "max", lengths=lengths,
        unsafe=True, initial=splits.NEG)
    return out.reshape(mc, L1, S + 1)


@dataclasses.dataclass(frozen=True)
class ShardedExactNumeric(_MeshEngine):
    """Exact supersplit with columns and (optionally) presorted rows
    sharded.

    Per (tree, column), each row shard computes its local per-leaf stat
    totals and last in-bag value; an all_gather over `row_axis` gives each
    shard the exclusive prefix of the shards before it (`h_init`,
    `v_init`) and the global totals; the shard scores its own slice of the
    presorted order resuming from that state (`backend`: "segment" or
    "scan", the reference's `NUMERIC_BACKENDS`); the partial bests merge
    by a first max over the shards, ties to the earliest shard, which is
    the sequential scan's order; an all_gather over `feature_axis`
    assembles the (T, m, L+1) result on every rank.  `row_axis=None` is
    the paper's column-only splitter layout: rows replicated, each column
    scored on its own totals, no row collective.
    """
    backend: str = "segment"

    def __post_init__(self):
        super().__post_init__()
        if self.backend not in NUMERIC_BACKENDS:
            raise ValueError(f"sharded exact backend must be one of "
                             f"{NUMERIC_BACKENDS}, got {self.backend!r}")

    def supersplits(self, inp, st, Lp, cand):
        self.mesh.begin_level(inp.leaf_of)
        with record_function("level.numeric_sharded"):
            return (*self._search(inp.sorted_vals, inp.sorted_idx,
                                  inp.leaf_of, inp.w, inp.stats, cand, Lp,
                                  st.impurity, st.task, st.min_records),
                    None)

    def __call__(self, sorted_vals, sorted_idx, leaf_of, w, stats, cand,
                 Lp, impurity, task, min_records):
        """Legacy per-tree supersplit_fn signature: leaf_of/w (n,), stats
        (n, S), cand (m, L+1) -> gains, thresholds (m, L+1)."""
        g, t = self._search(sorted_vals, sorted_idx, leaf_of[None], w[None],
                            stats[None], cand[None], Lp, impurity, task,
                            min_records)
        return g[0], t[0]

    def _search(self, sorted_vals, sorted_idx, leaf_of, w, stats, cand, Lp,
                impurity, task, min_records):
        T, n = leaf_of.shape
        m = sorted_vals.shape[0]
        cs = self._cols(m, "m_num (numeric columns)")
        rs = self._rows(n)
        sv = sorted_vals[cs, rs]                    # (m_loc, n_loc)
        si = sorted_idx[cs, rs].long()
        m_loc, n_loc = sv.shape
        L1, S = Lp + 1, stats.shape[-1]
        step = _column_chunk(m_loc, n_loc, S)
        chunks = [(t, j0, min(m_loc, j0 + step)) for t in range(T)
                  for j0 in range(0, m_loc, step)]

        def rows_of(t, j0, j1):     # the class list in this shard's order
            s = si[j0:j1]
            return leaf_of[t][s], w[t][s], stats[t][s]

        state = torch.empty((T, m_loc, L1, S + 1), dtype=torch.float64,
                            device=sv.device)
        for t, j0, j1 in chunks:
            state[t, j0:j1] = _shard_state(sv[j0:j1], *rows_of(t, j0, j1),
                                           L1)
        if self.row_axis is None:
            totals, h_init, v_init = state[..., :S], None, None
        else:
            every = self.mesh.all_gather(state, self.row_axis)
            r = self.mesh.axis_index(self.row_axis)
            totals = every[..., :S].sum(0)
            h_init = every[:r, ..., :S].sum(0)
            v_init = (every[:r, ..., S].amax(0) if r else
                      torch.full((T, m_loc, L1), splits.NEG,
                                 dtype=torch.float64, device=sv.device))
        gains = torch.empty((T, m_loc, L1), dtype=torch.float32,
                            device=sv.device)
        thr = torch.empty_like(gains)
        cand = cand[:, cs]
        for t, j0, j1 in chunks:
            kw = dict(totals=totals[t, j0:j1].to(torch.float32))
            if h_init is not None:
                kw.update(h_init=h_init[t, j0:j1],
                          v_init=v_init[t, j0:j1].to(torch.float32))
            lf, ww, stt = rows_of(t, j0, j1)
            if self.backend == "segment":
                g, h = splits.best_numeric_split_segment(
                    sv[j0:j1], lf, ww, stt, cand[t, j0:j1], Lp, impurity,
                    task, min_records, **kw)
            else:
                g, h = splits.scan_supersplit(
                    sv[j0:j1], lf, ww, stt, cand[t, j0:j1],
                    kw.pop("totals"), impurity, task, min_records, **kw)
            gains[t, j0:j1], thr[t, j0:j1] = g, h
        if self.row_axis is not None:
            # first max over the shards, ties to the earliest shard
            key = torch.where(torch.isfinite(gains), gains, splits.NEG)
            both = self.mesh.all_gather(torch.stack([key, thr]),
                                        self.row_axis)  # (R, 2, T, m_loc, L1)
            win = both[:, 0].argmax(0, keepdim=True)
            gains = torch.gather(both[:, 0], 0, win)[0]
            thr = torch.gather(both[:, 1], 0, win)[0]
        return self._gather_cols(gains), self._gather_cols(thr)


# ---------------------------------------------------------------------------
# Histogram engine: one all-reduce of (bins × stats) tables a level
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedHistNumeric(_MeshEngine):
    """Approximate supersplit for `split_mode="hist"`.

    Columns shard over `feature_axis`; ROWS, in plain row order, over
    `row_axis` with the class list.  Each rank builds the per-leaf (bin ×
    stat) tables of its columns over its rows through the `feat_hist`
    kernel wrapper, and one all-reduce over `row_axis` a level merges
    them.  Under `st.subtract` only the packed build-slot tables ((L/2+1)
    slots a column) cross the network, and each rank derives the siblings
    of its columns locally as parent − sibling from the tables it carried.
    Thresholds are BIN INDICES (`bin_cut_thresholds`), decoded on the
    host; an all_gather over `feature_axis` assembles them.  The carried
    tables are the rank's own columns.

    Out of core, each rank's accumulator is its row shard's slice of the
    reference's (R, T, ...) accumulator: `stream_accumulate` adds the
    tables of its rows of a chunk with no collective, and
    `stream_finalize` makes the level's one all-reduce.
    """

    needs_bins = True
    bin_cut_thresholds = True
    carries_tables = True
    supports_stream = True

    def stream_init(self, T, st, Lp, device):
        m_loc = self._cols(st.m_num, "m_num (numeric columns)")
        S = kops.stat_dim(st.num_classes, st.task)
        return torch.zeros((T, m_loc.stop - m_loc.start, Lp + 1,
                            st.num_bins, S), dtype=torch.float32,
                           device=device)

    def stream_accumulate(self, acc, bins, leaf, w, labels, st, Lp):
        cs = self._cols(st.m_num, "m_num (numeric columns)")
        rs = self._rows(leaf.shape[1], "a streamed chunk's rows")
        with record_function("level.hist_tables"):
            return acc.add_(kops.feature_tables(
                bins[cs, rs], leaf[:, rs], w[:, rs], labels[rs],
                B=st.num_bins, W=Lp + 1, task=st.task,
                num_classes=st.num_classes))

    def stream_finalize(self, acc):
        self.mesh.begin_level(acc)
        return self._row_reduce(acc)

    def score_tables(self, tables, cand, st):
        """Score this rank's columns' tables; cand (T, m_num, L+1) holds
        every column.  Returns the (T, m_num, L+1) gains and bin cuts."""
        cs = self._cols(st.m_num, "m_num (numeric columns)")
        with record_function("level.hist_score"):
            g, c = splits.best_numeric_split_histogram(
                tables, cand[:, cs], st.impurity, st.task, st.min_records)
        return self._gather_cols(g), self._gather_cols(c)

    def supersplits(self, inp, st, Lp, cand):
        self.mesh.begin_level(inp.leaf_of)
        maps = ((inp.prev_tables, inp.parent_of, inp.sib_of, inp.slot_of)
                if st.subtract else None)
        return self._search(inp.bin_of, _hist_build_rows(inp, st.subtract),
                            inp.w, inp.labels, cand, Lp, st, maps)

    def __call__(self, bin_of, bin_edges, leaf_of, w, stats, cand, Lp,
                 impurity, task, min_records):
        """Legacy per-tree hist supersplit_fn signature: float thresholds,
        decoded here from the edges.  The row labels are recovered from the
        stats (`_labels_from_stats`)."""
        st = LevelStatics(m_num=bin_of.shape[0], m_cat=0, max_arity=1,
                          num_classes=stats.shape[-1], impurity=impurity,
                          task=task, min_records=min_records,
                          num_bins=bin_edges.shape[-1])
        labels = _labels_from_stats(stats, w, task)
        g, c, _ = self._search(bin_of, leaf_of[None], w[None], labels,
                               cand[None], Lp, st, None)
        thr = torch.gather(bin_edges, 1, c[0].long())
        return g[0], torch.where(torch.isfinite(g[0]), thr, 0.0)

    def _search(self, bin_of, slots, w, labels, cand, Lp, st, maps):
        """slots (T, n) the rows' scatter slots (`_hist_build_rows`); maps
        the subtraction state (prev_tables, parent_of, sib_of, slot_of)
        under `st.subtract`, else None."""
        n = slots.shape[1]
        cs = self._cols(st.m_num, "m_num (numeric columns)")
        rs = self._rows(n)
        W = Lp // 2 + 1 if st.subtract else Lp + 1
        slots = slots[:, rs]
        ww, y = w[:, rs], labels[rs]
        bins = bin_of[cs, rs]
        with record_function("level.hist_tables"):
            # NO row compaction: the build rows' n/2 bound is global, not
            # per row shard (the derive-leaf rows carry slot 0)
            tables = self._merged_tables(
                lambda **kw: kops.feature_tables(
                    bins, slots, ww, y, B=st.num_bins, W=W, task=st.task,
                    num_classes=st.num_classes, **kw),
                slots, ww, y, W, st.task, n)
            if st.subtract:
                tables = _expand_subtracted(tables, *maps)
        return (*self.score_tables(tables, cand, st), tables)


# ---------------------------------------------------------------------------
# Categorical engine: one all-reduce of (category × stats) tables a level
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedCategorical(_MeshEngine):
    """Exact categorical search under the mesh: the paper's "attribute
    value × class" count tables of the rank's columns are built over its
    row shard through the `cat_hist` kernel wrapper and merged by one
    all-reduce over `row_axis` (categorical tables are order-free, so the
    merge is exact); the Breiman-ordered prefix cuts are then scored for
    the rank's columns, and an all_gather over `feature_axis` assembles
    the gains and left-masks (T·m_cat·(L+1)·V bools).  m_cat must be
    divisible by the feature-axis size.  As on one device, only the
    candidate (tree, column, leaf)s have a table: every row shard draws
    the same candidates, so their compact tables add slot for slot."""

    kind = "categorical"

    def supersplits(self, inp, st, Lp, cand):
        self.mesh.begin_level(inp.leaf_of)
        T, n = inp.leaf_of.shape
        cs = self._cols(st.m_cat, "m_cat (categorical columns)")
        rs = self._rows(n)
        leaf, ww, y = inp.leaf_of[:, rs], inp.w[:, rs], inp.labels[rs]
        x = inp.cat_cols[cs, rs]
        cand = cand[:, cs].contiguous()
        with record_function("level.cat_tables"):
            slot = cat_hist.candidate_slots(cand)
            tables = self._merged_tables(
                lambda **kw: kops.categorical_tables(
                    x, leaf, ww, y, V=st.max_arity, Lp=Lp, task=st.task,
                    num_classes=st.num_classes, slot=slot,
                    m_prime=st.m_prime or None, **kw),
                leaf, ww, y, Lp + 1, st.task, n)
        with record_function("level.cat_breiman"):
            g, masks = _score_tables(tables, cand, st, slot)
        return self._gather_cols(g), self._gather_cols(masks)
