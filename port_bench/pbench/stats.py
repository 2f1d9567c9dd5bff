"""Statistics over the samples of a window."""

from __future__ import annotations

from typing import Sequence


def mean(values: Sequence[float]) -> float:
    xs = [float(v) for v in values]
    if not xs:
        raise ValueError("a mean of no samples")
    return sum(xs) / len(xs)
