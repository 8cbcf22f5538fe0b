"""Device selection and the memory and thermal gauges of the port.

``MemoryTracker`` and ``ThermalMonitor`` are the counterparts of
``m2tts_tpu/utils/device.py:210-277``: the same metric keys, read from
torch's caching allocator for the trainer's device and from psutil for the
host.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for and none is present. Nothing falls back to the CPU: a caller that
    wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class MemoryTracker:
    """Current and peak device memory (``hbm_gb``, ``hbm_peak_gb``: tensors
    held by torch's caching allocator on a CUDA ``device``) and the host's
    resident set (``host_rss_gb``) for the metric logs."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.peak_hbm_gb = 0.0

    def update(self) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        if self.device.type == "cuda":
            current = torch.cuda.memory_allocated(self.device) / 1e9
            self.peak_hbm_gb = max(
                self.peak_hbm_gb, current,
                torch.cuda.max_memory_allocated(self.device) / 1e9)
            metrics["hbm_gb"] = current
            metrics["hbm_peak_gb"] = self.peak_hbm_gb
        try:
            import psutil

            metrics["host_rss_gb"] = psutil.Process().memory_info().rss / 1e9
        except ImportError:
            pass
        return metrics


class ThermalMonitor:
    """Host thermal guard; a no-op when psutil has no temperature
    sensors."""

    def __init__(self, threshold_c: float = 80.0, check_interval_s: float = 30.0):
        self.threshold_c = threshold_c
        self.check_interval_s = check_interval_s
        self._last_check = 0.0
        self._last_ok = True

    def current_temperature(self) -> Optional[float]:
        try:
            import psutil

            temps = psutil.sensors_temperatures()
        except (ImportError, AttributeError):
            return None
        readings = [t.current for entries in temps.values() for t in entries
                    if t.current is not None]
        return max(readings) if readings else None

    def check(self) -> bool:
        """True when safe to proceed. Rate-limited to check_interval_s."""
        now = time.monotonic()
        if now - self._last_check < self.check_interval_s:
            return self._last_ok
        self._last_check = now
        temp = self.current_temperature()
        self._last_ok = temp is None or temp < self.threshold_c
        if not self._last_ok:
            logger.warning("Host temperature %.1f°C >= %.1f°C", temp,
                           self.threshold_c)
        return self._last_ok

    def wait_for_cooldown(self, max_wait_s: float = 300.0,
                          poll_s: float = 10.0) -> None:
        start = time.monotonic()
        while time.monotonic() - start < max_wait_s:
            temp = self.current_temperature()
            if temp is None or temp < self.threshold_c:
                return
            time.sleep(poll_s)
