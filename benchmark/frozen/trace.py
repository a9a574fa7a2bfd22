"""The profiler arithmetic: device intervals from a torch.profiler trace,
their union (busy time), the gaps between them (idle time) and what the
host was running during each gap."""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The sorted, merged union of [start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(intervals: Sequence[Interval]) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Sequence[Interval], start: float,
         end: float) -> List[Interval]:
    """The stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def label_gaps(gap_list: Sequence[Interval],
               host: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle time by what the host ran at each gap's middle: the innermost
    host span (the latest start) that covers it, else "host (no span)";
    times in the units of the inputs."""
    spans = sorted(host)
    heap: list = []
    out: Dict[str, float] = {}
    k = 0
    for s, e in sorted(gap_list, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while k < len(spans) and spans[k][0] <= mid:
            heapq.heappush(heap, (-spans[k][0], spans[k][1], spans[k][2]))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)      # ends before this and every later gap
        name = heap[0][2] if heap else "host (no span)"
        out[name] = out.get(name, 0.0) + (e - s)
    return out
