"""The device trace of a traced segment, read from ``torch.profiler``'s
events in memory (no file is written).

Device activity is every event the profiler puts on the CUDA device that
is not an annotation: kernels, copies and fills. ``busy_s`` is the length
of their union inside the traced window, the window running from the first
to the last of the benchmark's own annotations (``pb.*``, put around each
call into the program). An idle gap is a stretch of the window with no
device activity; each is named by the innermost host event running on the
thread that drives the card when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

PREFIX = "pb."
Interval = Tuple[int, int]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Trace:
    def __init__(self, prof) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        self.kernels: List[Tuple[str, int, int]] = []
        self.copies: List[Interval] = []
        self.host: List[Tuple[int, int, str, int]] = []
        notes: List[Tuple[int, int, str, int]] = []
        for e in prof.profiler.kineto_results.events():
            name, start, end = e.name(), e.start_ns(), e.end_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name.startswith(PREFIX):
                    continue
                if _is_copy(name):
                    self.copies.append((start, end))
                else:
                    self.kernels.append((name, start, end))
            else:
                row = (start, end, name, e.start_thread_id())
                (notes if name.startswith(PREFIX) else self.host).append(row)
        if not notes:
            raise RuntimeError("the trace holds none of the benchmark's "
                               "annotations")
        self.lo = min(r[0] for r in notes)
        self.hi = max(r[1] for r in notes)
        self.thread = notes[0][3]
        self.host = sorted([r for r in self.host + notes if r[3] == self.thread])
        self._busy = self._union([(s, e) for _, s, e in self.kernels] + self.copies)

    def _union(self, spans: List[Interval]) -> List[Interval]:
        out: List[List[int]] = []
        for s, e in sorted(spans):
            s, e = max(s, self.lo), min(e, self.hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) / 1e9

    def kernel_count(self) -> int:
        return len(self.kernels)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for name, s, e in self.kernels:
            by[name[:160]] += e - s
        for s, e in self.copies:
            by["copies and fills"] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in rows]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The idle time of the window summed by the host event each gap
        began under, the largest ``k``."""
        gaps, at = [], self.lo
        for s, e in self._busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.hi > at:
            gaps.append((at, self.hi))
        starts = [r[0] for r in self.host]
        by: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            label = "no host event"
            i = bisect.bisect_right(starts, s) - 1
            # the innermost event holding s: the latest start whose end is
            # past s, looked for among the events that started before it
            best = None
            j = i
            while j >= 0 and j > i - 400:
                hs, he, name, _ = self.host[j]
                if he > s:
                    best = name
                    break
                j -= 1
            if best is not None:
                label = best
            by[label[:160]] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, t / 1e9] for n, t in rows]
