"""Reading a ``torch.profiler`` Chrome trace of a short stretch of work.

The device's busy time is the union of its kernels' spans; a kernel belongs
to a host span (the benchmark's ``record_function`` around a layer, or an
autograd node of the backward) when the runtime call that launched it lies
inside a span of that name on the same thread. Gaps between busy intervals
are labelled by the innermost host event on the launching thread that
covers the gap's start: what the host was doing while the device waited.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals: List[Interval]) -> float:
    """The length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


class Trace:
    """Kernels and host events of one trace, times in microseconds."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        launches = {}
        self.host: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
        self.kernels: List[Tuple[float, float, str, int]] = []
        for e in spans:
            ts, end, cat = float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat == "kernel":
                self.kernels.append((ts, end, e.get("name", ""), corr))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if corr is not None:
                    launches[corr] = (ts, e.get("tid"))
                self.host[e.get("tid")].append((ts, end, e.get("name", "")))
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                self.host[e.get("tid")].append((ts, end, e.get("name", "")))
        self.kernels.sort()
        self.launch = {corr: launches.get(corr) for *_, corr in self.kernels}
        for v in self.host.values():
            v.sort()

    @classmethod
    def load(cls, path: Path) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    def busy_us(self) -> float:
        return covered([(a, b) for a, b, *_ in self.kernels])

    def kernel_us(self, name_part: str) -> float:
        """Summed time of the kernels whose name holds `name_part`."""
        return sum(b - a for a, b, n, _ in self.kernels if name_part in n)

    def under(self, span: Callable[[str], bool]) -> float:
        """Summed time of the kernels launched inside a host span whose name
        satisfies `span`."""
        windows = {tid: union([(a, b) for a, b, n in ev if span(n)])
                   for tid, ev in self.host.items()}
        starts = {tid: [a for a, _ in w] for tid, w in windows.items()}
        total = 0.0
        for a, b, _, corr in self.kernels:
            launch = self.launch.get(corr)
            if launch is None or launch[1] not in windows:
                continue
            ts, tid = launch
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and ts <= windows[tid][i][1]:
                total += b - a
        return total

    def top_kernels(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for a, b, name, _ in self.kernels:
            by[name] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds between busy intervals, summed by the innermost host
        event that covers each gap's start on the thread that launched the
        kernel after the gap."""
        busy = union([(a, b) for a, b, *_ in self.kernels])
        first_at = {}
        for a, _, _, corr in self.kernels:
            first_at.setdefault(a, corr)
        queries = defaultdict(list)  # tid -> [(gap start, gap seconds)]
        by = defaultdict(float)
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            launch = self.launch.get(first_at.get(nxt))
            if launch is None:
                by["unlinked"] += (nxt - end) / 1e6
            else:
                queries[launch[1]].append((end, (nxt - end) / 1e6))
        for tid, qs in queries.items():
            events, i, stack = self.host.get(tid, []), 0, []
            for t, secs in sorted(qs):
                while i < len(events) and events[i][0] <= t:
                    while stack and stack[-1][1] < events[i][0]:
                        stack.pop()
                    stack.append(events[i])
                    i += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                by[stack[-1][2] if stack else "host outside any op"] += secs
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
