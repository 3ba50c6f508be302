"""Shared latency/summary statistics.

A copy of ``repro.obs.stats`` (the port imports nothing of ``repro``);
``tests/test_torch_obs.py`` holds both functions equal to the original.
Linear interpolation between order statistics (numpy's default), ``nan``
on empty input.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation; nan if empty."""
    s = sorted(float(x) for x in xs)   # list() first: len-1 ndarray truthiness
    if not s:
        return float("nan")
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def summarize(xs: Sequence[float]) -> Dict[str, float]:
    """count/mean/min/max/p50/p95 — the obs histogram-record payload."""
    xs = [float(x) for x in xs]
    if not xs:
        return {"count": 0}
    return {
        "count": len(xs),
        "mean": sum(xs) / len(xs),
        "min": min(xs),
        "max": max(xs),
        "p50": percentile(xs, 50.0),
        "p95": percentile(xs, 95.0),
    }
