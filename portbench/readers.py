"""Readings shared by the per-layer metrics' readers (``layer_metrics/``).
Each takes the traced run's record and returns None where the record has
nothing to read, never 0 for a share of a roofline or a peak."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from portbench.work import PEAK_FLOPS


def roofline_pct(rec: Dict) -> Optional[float]:
    """The vocoder launches' summed bounds over their summed device time."""
    bound, spent = rec.get("vocoder_bound_s"), rec.get("vocoder_device_s")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent


def mfu_pct(rec: Dict, over: str = "window_s") -> Optional[float]:
    """FLOPs of the audio served (counted on the reference) over the
    seconds ``rec[over]`` (the window's wall by default) and the card's
    bf16 peak."""
    flops, wall = rec.get("model_flops"), rec.get(over)
    if not flops or not wall:
        return None
    return 100.0 * flops / wall / PEAK_FLOPS["bf16"]


def idle_pct(rec: Dict) -> Optional[float]:
    busy, wall = rec.get("busy_s"), rec.get("window_s")
    if busy is None or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)


def span_ms_per_call(rec: Dict, name: str) -> Optional[float]:
    calls, spans = rec.get("calls"), rec.get("spans_s", {})
    if not calls or not spans.get(name):
        return None
    return 1e3 * spans[name] / calls


def p95(values) -> Optional[float]:
    return float(np.percentile(values, 95)) if len(values) else None
