"""Reading the device trace of a traced run (``torch.profiler``, CUPTI).

Device busy time is the union of the intervals of every device activity
(kernels, copies, fills): ``busy_us`` is ``tools/profile_solve.py``'s,
frozen. Kernels are found by name. The idle gaps between device
activities are put down to the outermost host operation in progress
where each gap starts.
"""

from __future__ import annotations

import bisect
import collections
import math


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """What a traced window's profile holds: device intervals, kernel
    time by name, and the host's outermost operations."""

    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.intervals, host = [], []
        self.by_name = collections.defaultdict(lambda: [0, 0.0])
        # the profiler's raw events: building its FunctionEvent tree
        # (prof.events()) takes minutes on a window of some 1e5 operations
        for e in prof.profiler.kineto_results.events():
            span = (e.start_ns() * 1e-3, e.end_ns() * 1e-3)   # us
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                self.intervals.append(span)
                row = self.by_name[e.name()]
                row[0] += 1
                row[1] += (span[1] - span[0]) * 1e-6
            elif kind == DeviceType.CPU:
                host.append((span[0], span[1], e.name()))
        self.n_events = len(self.intervals) + len(host)
        # the outermost host operations: those no earlier one contains
        host.sort(key=lambda h: (h[0], -h[1]))
        self.host, end = [], -math.inf
        for h in host:
            if h[0] >= end:
                self.host.append(h)
                end = h[1]
        self.busy_s = busy_us(self.intervals) * 1e-6

    def kernels(self, pattern: str) -> tuple:
        """(launches, device seconds) of the kernels whose name holds
        ``pattern``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.by_name.items():
            if pattern in name:
                n, s = n + c, s + sec
        return n, s

    def device_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [name, seconds]."""
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])
        return [[name[:200], sec] for name, (_, sec) in rows[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between device activities, summed by the outermost
        host operation in progress where each gap starts: the k largest,
        [name, seconds]."""
        starts = [h[0] for h in self.host]
        total = collections.Counter()
        spans = merged(self.intervals)
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            j = bisect.bisect_right(starts, e0) - 1
            name = "(no host operation)"
            if j >= 0 and self.host[j][1] >= e0:
                name = self.host[j][2]
            total[name[:200]] += (s1 - e0) * 1e-6
        return [[n, s] for n, s in total.most_common(k)]


def profiler():
    """A profiler of host operations and device activity."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi gave nothing (rc {out.returncode})")
