"""The traced window: `torch.profiler` around the fits, reduced to what the
per-layer metrics and the breakdown read.

All times are the profiler's microseconds.  The window is the host range
`bench.window` the harness opens around its fits.  Device busy time is
the union of the intervals of every device operation (kernels, copies,
sets) inside it.  A record_function range of the program (`level.*`,
`fit.*`, `stream.*`) appears twice: as a host interval on the thread
that opened it, and as a device-side span covering the device work
queued inside it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"
RANGE_PREFIXES = ("level.", "fit.", "stream.", "bench.")
TOP = 10


def merge(intervals) -> list:
    """Sorted disjoint union of (lo, hi) intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def covered(merged, lo, hi) -> float:
    """Length of [lo, hi] covered by sorted disjoint intervals."""
    i = max(0, bisect.bisect_right(merged, [lo, float("inf")]) - 1)
    out = 0.0
    while i < len(merged) and merged[i][0] < hi:
        out += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
        i += 1
    return out


@dataclasses.dataclass
class Trace:
    window: tuple               # (lo, hi)
    busy: list                  # merged device busy intervals
    device_ops: dict            # name -> total us
    device_spans: dict          # range name -> [(lo, hi)] device side
    host_ranges: dict           # range name -> [(lo, hi)] host side
    idle_by_host: dict          # what the host was in -> idle us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy) / 1e6

    def span_s(self, names) -> float | None:
        """Device seconds inside any of the ranges `names` (nested ranges
        counted once); None where none of them ran."""
        iv = [x for nm in names for x in self.device_spans.get(nm, ())]
        return sum(hi - lo for lo, hi in merge(iv)) / 1e6 if iv else None

    def exposed_s(self, names) -> float | None:
        """Host seconds inside the ranges `names` that no device operation
        overlapped; None where none of them ran."""
        iv = merge(x for nm in names for x in self.host_ranges.get(nm, ()))
        if not iv:
            return None
        return sum((hi - lo) - covered(self.busy, lo, hi)
                   for lo, hi in iv) / 1e6

    def kernel_s(self, pattern) -> float | None:
        t = sum(us for nm, us in self.device_ops.items()
                if pattern.match(nm))
        return t / 1e6 if t else None

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[nm, us / 1e6] for nm, us in top],
                "idle_gaps": [[nm, us / 1e6] for nm, us in gaps]}


def _idle_names(gaps, host_events) -> dict:
    """Idle microseconds by what the window's host thread was in at each
    gap's midpoint: its innermost range and innermost operation."""
    out = collections.defaultdict(float)
    if not gaps:
        return out
    events = sorted(host_events, key=lambda e: (e[0], -e[1]))
    stack, i = [], 0
    for lo, hi in sorted(gaps):
        q = (lo + hi) / 2
        while i < len(events) and events[i][0] <= q:
            stack.append(events[i])
            i += 1
        stack = [e for e in stack if e[1] >= q]
        rng = next((e[2] for e in reversed(stack)
                    if e[2].startswith(RANGE_PREFIXES)), "-")
        op = next((e[2] for e in reversed(stack)
                   if not e[2].startswith(RANGE_PREFIXES)), None)
        out[rng if op is None else f"{rng} / {op}"] += hi - lo
    return out


def summarize(prof) -> Trace:
    """Reduce a finished `torch.profiler.profile` to a `Trace`, from the
    profiler's raw events (nanoseconds, read as microseconds)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW
               and e.device_type() == DeviceType.CPU)
    lo, hi = win.start_ns() / 1e3, win.end_ns() / 1e3
    thread = win.start_thread_id()
    work, ops = [], collections.defaultdict(float)
    spans = collections.defaultdict(list)
    host = collections.defaultdict(list)
    main = []
    for e in events:
        a, b, name = e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() == thread and lo <= a and b <= hi:
                main.append((a, b, name))
                if name.startswith(RANGE_PREFIXES):
                    host[name].append((a, b))
            continue
        if e.is_user_annotation():
            spans[name].append((a, b))
            continue
        a, b = max(a, lo), min(b, hi)
        if b > a:
            work.append((a, b))
            ops[name] += b - a
    busy = merge(work)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    return Trace(window=(lo, hi), busy=busy, device_ops=dict(ops),
                 device_spans=dict(spans), host_ranges=dict(host),
                 idle_by_host=dict(_idle_names(gaps, main)))
