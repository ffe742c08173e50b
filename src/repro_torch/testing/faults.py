"""Fault-injection harness for streamed training, ported from
`repro.testing.faults`.

Three failure modes, each mapping to a real large-scale incident:

* transient read failures  — a flaky disk / network filesystem read
  that succeeds on retry (`FaultyRowSource(transient=...)`);
* persistent read failures — a dead shard: every retry fails and the
  driver must escalate `StreamReadError` after flushing its checkpoint
  (`FaultyRowSource(persistent=...)`);
* process death            — SIGKILL at a scheduled read, after the
  Nth level snapshot, or in the worst atomic-write window (between the
  tmp write and `os.replace`): `kill_after_reads=`,
  `arm_kill_after_snapshots`, `arm_kill_mid_replace`.

SIGKILL (not an exception) is deliberate: nothing — no `finally`, no
atexit — runs, exactly like a preemption.  The kill-based hooks are
therefore only usable from a SUBPROCESS: a test spawns one, waits for
return code -9, then resumes in its own process and compares the trees
node for node with an uninterrupted fit.
"""
from __future__ import annotations

import os
import signal

from repro_torch.core import atomicio, checkpoint
from repro_torch.core.dataset import RowSource


def sigkill_self() -> None:
    """Die like a preempted worker: no cleanup handlers run."""
    os.kill(os.getpid(), signal.SIGKILL)


class FaultyRowSource(RowSource):
    """A `RowSource` wrapper with scheduled read failures.

    Read indices count LOGICAL reads (completed `bins_block` /
    `bins_take` calls): retries of a failing read observe the same
    index, so `transient={i: k}` makes logical read i fail k times and
    then succeed — precisely the contract `read_with_retry` is built
    for — while `persistent={i}` makes it fail on every attempt.

    The wrapper inherits the inner source's identity (labels, edges,
    task), so its fingerprint matches and checkpoints taken under
    faults resume cleanly against the pristine source.  `retry_sleep`
    defaults to a no-op: the backoff schedule is exercised, the suite
    does not wait for it.
    """

    def __init__(self, inner: RowSource, *, transient=None, persistent=(),
                 kill_after_reads=None, error=OSError,
                 retry_attempts: int = 4, retry_base_delay: float = 0.05,
                 retry_max_delay: float = 2.0, retry_sleep=lambda _: None):
        super().__init__(inner.edges, inner.labels,
                         num_classes=inner.num_classes, task=inner.task,
                         chunk_size=inner.chunk_size)
        self.inner = inner
        self.transient = dict(transient or {})
        self._remaining = dict(self.transient)
        self.persistent = frozenset(persistent)
        self.kill_after_reads = kill_after_reads
        self.error = error
        self.retry_attempts = int(retry_attempts)
        self.retry_base_delay = float(retry_base_delay)
        self.retry_max_delay = float(retry_max_delay)
        self.retry_sleep = retry_sleep
        self.reads = 0          # completed logical reads
        self.attempts = 0       # every call, including failed ones

    def _inject(self) -> None:
        self.attempts += 1
        idx = self.reads
        if (self.kill_after_reads is not None
                and idx >= self.kill_after_reads):
            sigkill_self()
        if idx in self.persistent:
            raise self.error(f"injected persistent fault at read {idx}")
        if self._remaining.get(idx, 0) > 0:
            self._remaining[idx] -= 1
            raise self.error(
                f"injected transient fault at read {idx} "
                f"({self._remaining[idx]} left)")

    def bins_block(self, lo: int, hi: int):
        self._inject()
        out = self.inner.bins_block(lo, hi)
        self.reads += 1
        return out

    def bins_take(self, idx):
        self._inject()
        out = self.inner.bins_take(idx)
        self.reads += 1
        return out


# ---------------------------------------------------------------------------
# Kill hooks (subprocess-only — they SIGKILL the calling process)
# ---------------------------------------------------------------------------

def arm_kill_after_snapshots(nth: int = 1) -> None:
    """SIGKILL right after the `nth` level snapshot lands on disk —
    the kill-at-level scenario: the snapshot is complete, the levels
    after it are lost and must be replayed on resume."""
    count = [0]

    def hook(depth, path):
        count[0] += 1
        if count[0] >= nth:
            sigkill_self()
    checkpoint.POST_SNAPSHOT_HOOK[0] = hook


def arm_kill_mid_replace(nth: int = 1, match: str = "") -> None:
    """SIGKILL between an atomic write's tmp flush and its `os.replace`
    — the worst mid-checkpoint (or mid-`PackedForest.save`) window: a
    naive writer would have clobbered the target by now.  `match`
    restricts the kill to paths containing it; `nth` counts matching
    writes."""
    count = [0]

    def hook(final_path, tmp_path):
        if match and match not in os.fspath(final_path):
            return
        count[0] += 1
        if count[0] >= nth:
            sigkill_self()
    atomicio.PRE_REPLACE_HOOK[0] = hook


def disarm() -> None:
    """Clear every armed hook (harmless if none are armed)."""
    checkpoint.POST_SNAPSHOT_HOOK[0] = None
    atomicio.PRE_REPLACE_HOOK[0] = None
