"""Level-granular checkpoint/resume for streamed training, ported from
`repro.core.checkpoint` (the same directory layout, manifest, snapshot
and trees files, and version field: a directory written by either
package resumes in the other).

The streamed driver (`tree.build_forest_streamed`) is uniquely cheap to
checkpoint: between depth levels ALL of its n-sized training state is
already host-resident numpy — the (T, n_act) leaf ids, the flat-tree
accumulators, the finalized level's split decisions, and the pruning
row map.  Bag weights and PRNG keys need no snapshot at all because
every random draw is a pure function of (seed, tree index) (paper
§2.2); the resume path re-derives them bit-exactly.  A snapshot is
therefore a single uncompressed .npz per tree batch, written atomically
(tmp + `os.replace`, `repro_torch.core.atomicio`), and resuming from it
replays the remaining levels through the same level steps — node for
node identical to the uninterrupted fit, also after a SIGKILL.  The
level's split decisions live on the fit's device; a snapshot holds host
numpy copies, and a resume moves them back.

Layout of a checkpoint directory (one per forest fit):

    manifest.json          fingerprints (source / params / seed) +
                           the set of COMPLETED tree batches
    trees_<lo>-<hi>.npz    finished trees of a completed batch
    snap_<lo>-<hi>.npz     level snapshot of the in-flight batch
                           (deleted once its batch completes)

`manifest.json` is the commit record: a batch exists only once the
manifest says so, and the trees file is written (atomically) BEFORE
the manifest update, so a kill between the two merely retrains that
batch.  Resuming against the wrong cache/params/seed raises
`CheckpointMismatchError` before any state is touched.

Under `torch.distributed` only rank 0 writes, while every rank
fingerprint-checks the manifest it can read: the snapshot holds
replicated host state, so one copy is enough.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from repro_torch.core import atomicio

FORMAT_VERSION = 1

# Wall-clock seconds spent inside checkpoint writes (snapshots, trees,
# manifests); a caller reads the delta around a checkpointed fit.
CKPT_WALL = [0.0]

# Test hook (repro_torch.testing.faults): called after each level snapshot
# lands on disk, with (depth, path) — armed to SIGKILL at a chosen
# level for the kill-and-resume parity tests.
POST_SNAPSHOT_HOOK: list = [None]


class CheckpointError(RuntimeError):
    """A checkpoint directory is unusable (corrupt / wrong version)."""


class CheckpointMismatchError(CheckpointError):
    """Resume state does not match the fit (source / params / seed)."""


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def source_fingerprint(source) -> dict:
    """Identity of a `dataset.RowSource` for resume validation.

    Covers everything a streamed fit reads from the source that shapes
    the trees: row/column counts, the bucket budget, the task/classes,
    and a content hash of the decoded edges (two caches quantized from
    different data share none of these by accident)."""
    edges = np.ascontiguousarray(source.edges, np.float32)
    return {
        "n": int(source.n),
        "m_num": int(source.m_num),
        "num_bins": int(source.num_bins),
        "num_classes": int(source.num_classes),
        "task": str(source.task),
        "edges_sha256": hashlib.sha256(edges.tobytes()).hexdigest(),
    }


def params_fingerprint(params) -> dict:
    """`TreeParams` as a jsonable dict (every field shapes the trees)."""
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else repr(v))
            for k, v in dataclasses.asdict(params).items()}


def _process_index() -> int:
    """This process's rank in the `torch.distributed` group, 0 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


# ---------------------------------------------------------------------------
# _NodeAccum (flat-tree accumulator) serialization
# ---------------------------------------------------------------------------

def _pack_acc(acc, open_nodes) -> dict:
    """Flatten one `tree._NodeAccum` + its open-node ids to numpy arrays.

    Streamed training is numeric-only, so `is_cat` is all-False and
    `cat_mask` all-None by construction — asserted here rather than
    serialized.  Exact-width dtypes (float64 for thresholds/gains that
    live as Python floats) make the round trip bit-lossless."""
    assert not any(acc.is_cat), "streamed accumulators are numeric-only"
    assert all(cm is None for cm in acc.cat_mask)
    n_nodes = len(acc.feature)
    value = (np.stack(acc.value).astype(np.float32) if n_nodes
             else np.zeros((0, acc._C), np.float32))
    return {
        "feature": np.asarray(acc.feature, np.int64),
        "threshold": np.asarray(acc.threshold, np.float64),
        "children": (np.asarray(acc.children, np.int64).reshape(n_nodes, 2)
                     if n_nodes else np.zeros((0, 2), np.int64)),
        "value": value,
        "n_node": np.asarray(acc.n_node, np.float64),
        "gain": np.asarray(acc.gain, np.float64),
        "depth": np.asarray(acc.depth, np.int64),
        "open": np.asarray(open_nodes, np.int64),
    }


def _unpack_acc(arrs: dict, num_classes: int, task: str):
    """Rebuild (`_NodeAccum`, open_nodes) from `_pack_acc` arrays."""
    from repro_torch.core.tree import _NodeAccum
    acc = _NodeAccum(num_classes, task)
    n_nodes = len(arrs["feature"])
    acc.feature = [int(x) for x in arrs["feature"]]
    acc.threshold = [float(x) for x in arrs["threshold"]]
    acc.is_cat = [False] * n_nodes
    acc.cat_mask = [None] * n_nodes
    acc.children = [[int(a), int(b)] for a, b in arrs["children"]]
    acc.value = [np.ascontiguousarray(row) for row in
                 np.asarray(arrs["value"], np.float32)]
    acc.n_node = [float(x) for x in arrs["n_node"]]
    acc.gain = [float(x) for x in arrs["gain"]]
    acc.depth = [int(x) for x in arrs["depth"]]
    return acc, [int(x) for x in arrs["open"]]


# ---------------------------------------------------------------------------
# Finished-tree serialization (per completed batch)
# ---------------------------------------------------------------------------

_TREE_FIELDS = ("feature", "threshold", "is_cat", "cat_mask", "children",
                "value", "n_node", "gain", "depth")


def pack_stats(stats_logs) -> np.ndarray:
    """`LevelStats` logs as one json scalar array (npz-embeddable)."""
    return np.array(json.dumps(
        [[dataclasses.asdict(s) for s in log] for log in stats_logs]))


def unpack_stats(arr) -> list:
    """The inverse of `pack_stats`.  The reference's `LevelStats` has no
    `wall_seconds`; its logs load with 0.0 there."""
    from repro_torch.core.tree import LevelStats
    return [[LevelStats(**{"wall_seconds": 0.0, **d}) for d in log]
            for log in json.loads(str(arr))]


def _pack_trees(trees, stats_logs) -> dict:
    out = {"format_version": np.int32(FORMAT_VERSION),
           "num_trees": np.int32(len(trees)),
           "m_num": np.int32(trees[0].m_num),
           "task": np.array(trees[0].task)}
    for i, tr in enumerate(trees):
        for f in _TREE_FIELDS:
            out[f"t{i}_{f}"] = np.asarray(getattr(tr, f))
    out["stats_json"] = pack_stats(stats_logs)
    return out


def _unpack_trees(z) -> tuple[list, list]:
    from repro_torch.core.tree import Tree
    m_num, task = int(z["m_num"]), str(z["task"])
    trees = [Tree(m_num=m_num, task=task,
                  **{f: np.asarray(z[f"t{i}_{f}"]) for f in _TREE_FIELDS})
             for i in range(int(z["num_trees"]))]
    return trees, unpack_stats(z["stats_json"])


def _save_npz(path: str, arrays: dict) -> None:
    # uncompressed on purpose: checkpoints are transient (deleted at batch
    # commit) and written on the fit's critical path, where compression
    # costs time and buys nothing that is kept
    def write(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    t0 = time.perf_counter()
    atomicio.atomic_replace(path, write)
    CKPT_WALL[0] += time.perf_counter() - t0


def _shrink_ids(a: np.ndarray) -> np.ndarray:
    """Smallest exact unsigned dtype for a non-negative id array — the
    (T, n_act) leaf ids and the row map are the only n-sized payloads in
    a snapshot, and their value ranges are tiny compared to their storage
    dtype (uint8 covers leaf ids to depth 7, uint32 any practical n)."""
    hi = int(a.max()) if a.size else 0
    for dt in (np.uint8, np.uint16, np.uint32):
        if hi <= np.iinfo(dt).max:
            return a.astype(dt)
    return np.ascontiguousarray(a)


# ---------------------------------------------------------------------------
# Streamed-driver level snapshots
# ---------------------------------------------------------------------------
#
# Captured at the END of a level iteration in `build_forest_streamed`,
# after the level's bookkeeping and Sprint pruning: the (T, n_act) leaf
# ids, the pruning row map, the frontier sizes, the level's finalized
# split decisions (the `dec` tuple the NEXT level's chunk pass replays,
# copied from the device), and the flat-tree accumulators.  Labels and bag weights are NOT stored
# — both are re-derived on resume (labels from the source, weights from
# the seeded bagging) and compacted by the stored row map, bit-exactly.

def _host(t) -> np.ndarray:
    """A host numpy copy of a (device) tensor or array."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def pack_stream_state(*, tidx, depth, Ls, leaf_np, active, dec, Lpp,
                      accs, open_nodes, stats_logs) -> dict:
    state = {
        "format_version": np.int32(FORMAT_VERSION),
        "tidx": np.asarray([int(t) for t in tidx], np.int64),
        "next_depth": np.int64(depth + 1),
        "Lpp": np.int64(Lpp),
        "Ls": np.asarray(Ls, np.int64),
        "leaf": _shrink_ids(np.ascontiguousarray(leaf_np)),
        "dec_feat": _host(dec[0]),
        "dec_thr": _host(dec[1]),
        "dec_left": _host(dec[2]),
        "dec_right": _host(dec[3]),
        "stats_json": pack_stats(stats_logs),
    }
    if active is not None:
        state["active"] = _shrink_ids(np.asarray(active))
    for i, (acc, opn) in enumerate(zip(accs, open_nodes)):
        for k, v in _pack_acc(acc, opn).items():
            state[f"a{i}_{k}"] = v
    return state


def unpack_stream_state(state: dict, *, num_classes: int, task: str) -> dict:
    T = len(state["tidx"])
    accs, open_nodes = [], []
    for i in range(T):
        pre = f"a{i}_"
        acc, opn = _unpack_acc(
            {k[len(pre):]: v for k, v in state.items()
             if k.startswith(pre)}, num_classes, task)
        accs.append(acc)
        open_nodes.append(opn)
    return {
        "next_depth": int(state["next_depth"]),
        "Lpp": int(state["Lpp"]),
        "Ls": [int(x) for x in state["Ls"]],
        "leaf": np.ascontiguousarray(state["leaf"], np.int32),
        "active": (np.ascontiguousarray(state["active"], np.int64)
                   if "active" in state else None),
        # host numpy: the driver moves them to the fit's device
        "dec": (state["dec_feat"], state["dec_thr"],
                state["dec_left"], state["dec_right"]),
        "accs": accs,
        "open_nodes": open_nodes,
        "stats_logs": unpack_stats(state["stats_json"]),
    }


# ---------------------------------------------------------------------------
# The checkpointer
# ---------------------------------------------------------------------------

class StreamCheckpointer:
    """Manages one checkpoint directory across a streamed forest fit.

    `prepare` validates (or initializes) the manifest; per tree batch
    the driver calls `save_snapshot` after each completed level,
    `flush` before escalating a read failure, and `finish_batch` when
    the batch's trees are done; `load_batch`/`load_snapshot` feed the
    resume path.  All writes are atomic and happen only on rank 0.
    """

    def __init__(self, directory, *, every: int = 1):
        self.dir = os.fspath(directory)
        self.every = max(1, int(every))
        self.is_writer = _process_index() == 0
        self._manifest: Optional[dict] = None
        self._pending: Optional[tuple] = None   # (key, depth, state)

    # -- paths ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    @staticmethod
    def batch_key(tidx) -> str:
        tidx = [int(t) for t in tidx]
        return f"{tidx[0]}-{tidx[-1]}"

    def _trees_path(self, key: str) -> str:
        return os.path.join(self.dir, f"trees_{key}.npz")

    def _snap_path(self, key: str) -> str:
        return os.path.join(self.dir, f"snap_{key}.npz")

    # -- lifecycle ------------------------------------------------------
    def prepare(self, *, source, params, seed: int, resume: bool) -> None:
        """Fingerprint-check an existing manifest or initialize a fresh one.

        `resume=True` against a populated directory validates that the
        source/params/seed match what the checkpoints were written for
        (`CheckpointMismatchError` otherwise); against an empty
        directory it simply starts fresh, so crash-loop supervisors can
        pass `resume=True` unconditionally.  `resume=False` discards
        any prior state."""
        meta = {"source": source_fingerprint(source),
                "params": params_fingerprint(params),
                "seed": int(seed)}
        existing = self._read_manifest()
        if resume and existing is not None:
            if int(existing.get("format_version", -1)) != FORMAT_VERSION:
                raise CheckpointError(
                    f"checkpoint dir {self.dir!r} is format "
                    f"v{existing.get('format_version')}; this build reads "
                    f"v{FORMAT_VERSION} — delete it or train fresh")
            bad = [k for k in meta if existing["meta"].get(k) != meta[k]]
            if bad:
                raise CheckpointMismatchError(
                    f"checkpoint dir {self.dir!r} was written for a "
                    f"different fit (mismatched: {', '.join(bad)}) — "
                    f"resuming would mix trees from two configurations. "
                    f"Point checkpoint_dir at the matching cache/params "
                    f"or pass resume=False to discard it")
            self._manifest = existing
            return
        self._manifest = {"format_version": FORMAT_VERSION, "meta": meta,
                          "batches": {}}
        if self.is_writer:
            os.makedirs(self.dir, exist_ok=True)
            for f in os.listdir(self.dir):   # drop stale batch artifacts
                if f.startswith(("trees_", "snap_")) and f.endswith(".npz"):
                    os.unlink(os.path.join(self.dir, f))
            self._write_manifest()

    def _read_manifest(self) -> Optional[dict]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointError(
                f"unreadable checkpoint manifest "
                f"{self._manifest_path()!r}: {e}") from e

    def _write_manifest(self) -> None:
        if not self.is_writer:
            return
        t0 = time.perf_counter()
        atomicio.atomic_write_json(self._manifest_path(), self._manifest)
        CKPT_WALL[0] += time.perf_counter() - t0

    # -- completed batches ---------------------------------------------
    def load_batch(self, tidx) -> Optional[tuple[list, list]]:
        """(trees, stats) of a COMPLETED batch, or None if not finished."""
        key = self.batch_key(tidx)
        entry = self._manifest["batches"].get(key)
        if entry is None:
            return None
        if entry["tree_indices"] != [int(t) for t in tidx]:
            raise CheckpointMismatchError(
                f"checkpoint batch {key!r} holds trees "
                f"{entry['tree_indices']} but the fit asked for "
                f"{[int(t) for t in tidx]} — tree_batch changed between "
                f"runs; resume with the original batch size")
        path = self._trees_path(key)
        try:
            with np.load(path, allow_pickle=False) as z:
                return _unpack_trees(z)
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointError(
                f"manifest lists completed batch {key!r} but its trees "
                f"file {path!r} is missing or unreadable ({e}) — the "
                f"directory was tampered with; delete it and retrain"
            ) from e

    def finish_batch(self, tidx, trees, stats_logs) -> None:
        """Commit a finished batch: trees file, then manifest, then drop
        the level snapshot.  Ordered so a kill between any two steps
        loses at most this batch's recompute."""
        key = self.batch_key(tidx)
        self._pending = None
        if not self.is_writer:
            return
        _save_npz(self._trees_path(key), _pack_trees(trees, stats_logs))
        self._manifest["batches"][key] = {
            "tree_indices": [int(t) for t in tidx]}
        self._write_manifest()
        snap = self._snap_path(key)
        if os.path.exists(snap):
            os.unlink(snap)

    # -- level snapshots ------------------------------------------------
    def save_snapshot(self, tidx, depth: int, state: dict) -> None:
        """Record level `depth`'s end-of-level state; write it to disk
        on the `checkpoint_every` cadence (the latest state is always
        held pending so `flush` can persist it on failure)."""
        key = self.batch_key(tidx)
        self._pending = (key, depth, state)
        if (depth + 1) % self.every == 0:
            self.flush()

    def flush(self) -> None:
        """Write the held snapshot now (no-op when already on disk)."""
        if self._pending is None or not self.is_writer:
            return
        key, depth, state = self._pending
        self._pending = None
        path = self._snap_path(key)
        _save_npz(path, state)
        if POST_SNAPSHOT_HOOK[0] is not None:
            POST_SNAPSHOT_HOOK[0](depth, path)

    def load_snapshot(self, tidx) -> Optional[dict]:
        """The in-flight batch's level snapshot as a dict of arrays, or
        None (start the batch from depth 0)."""
        path = self._snap_path(self.batch_key(tidx))
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                state = {k: np.asarray(v) for k, v in z.items()}
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"unreadable level snapshot {path!r}: {e} — it was "
                f"written atomically, so this is external corruption; "
                f"delete the file to retrain the batch from scratch"
            ) from e
        if int(state["format_version"]) != FORMAT_VERSION:
            raise CheckpointError(
                f"level snapshot {path!r} is format "
                f"v{int(state['format_version'])}; this build reads "
                f"v{FORMAT_VERSION}")
        if list(state["tidx"]) != [int(t) for t in tidx]:
            raise CheckpointMismatchError(
                f"level snapshot {path!r} holds trees "
                f"{list(state['tidx'])}, not {[int(t) for t in tidx]}")
        return state
