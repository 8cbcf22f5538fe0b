"""Device selection, inventory and the memory and thermal gauges of the
port.

``setup_devices``, ``get_device_info``, ``hbm_usage``, ``clear_caches``,
``MemoryTracker`` and ``ThermalMonitor`` are the counterparts of
``m2tts_tpu/utils/device.py`` (``:133-208``, ``:210-281``): the same keys,
read from ``torch.cuda`` (the caching allocator and the driver's free/total
count) for the devices, from ``torch.distributed`` for the process index
and count (one process a device, where JAX has one process a host), and
from psutil for the host. The JAX module's XLA compile-cache helpers
(``enable_persistent_compile_cache``, ``honor_platform_env`` and the host
fingerprint that scopes the cache) have no counterpart: PyTorch runs
eagerly and compiles no graph per bucket, and the port's CUDA kernels are
cached by ``ops/cuda/build.py`` under a hash of their sources.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

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


def setup_devices(platform: Optional[str] = None) -> List[torch.device]:
    """The devices this process runs on: ``platform`` ('cuda' or 'cpu';
    CUDA when present by default). Under a process group a CUDA process
    runs on its current device alone; without one, on every CUDA device.
    'cuda' without CUDA raises."""
    dev = resolve_device(platform or ("cuda" if torch.cuda.is_available()
                                      else "cpu"))
    if dev.type != "cuda":
        devices = [dev]
    elif dist.is_initialized():
        devices = [torch.device("cuda", torch.cuda.current_device())]
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    logger.info("Using %d %s device(s)", len(devices), dev.type)
    return devices


def get_device_info() -> Dict[str, Any]:
    """Host and accelerator inventory: the JAX function's keys (backend,
    device counts and names, process index and count, the psutil host
    fields when psutil is present) and, per CUDA device, its properties
    (name, total memory, SM count, compute capability). The process index
    and count are the rank and world size of the process group when one
    is up."""
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    info: Dict[str, Any] = {
        "backend": "cuda" if cuda else "cpu",
        "device_count": count if cuda else 1,
        "local_device_count": count if cuda else 1,
        "devices": ([f"cuda:{i}" for i in range(count)] if cuda
                    else ["cpu"]),
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": (dist.get_world_size() if dist.is_initialized()
                          else 1),
    }
    if cuda:
        props = []
        for i in range(count):
            p = torch.cuda.get_device_properties(i)
            props.append({"name": p.name,
                          "total_memory_gb": p.total_memory / 1e9,
                          "sm_count": p.multi_processor_count,
                          "capability": f"{p.major}.{p.minor}"})
        info["device_properties"] = props
    try:
        import psutil

        vm = psutil.virtual_memory()
        info["host_memory_total_gb"] = vm.total / 1e9
        info["host_memory_available_gb"] = vm.available / 1e9
        info["host_cpu_count"] = psutil.cpu_count()
    except ImportError:
        pass
    return info


def hbm_usage() -> List[Dict[str, float]]:
    """Per CUDA device, memory in GB with the JAX keys: bytes held by
    torch's caching allocator (``bytes_in_use_gb``), the device's total
    (``bytes_limit_gb``), the allocator's peak (``peak_bytes_gb``), and
    what the driver reports free (``free_gb``, every process counted).
    Empty without a CUDA device, as the JAX function is on a backend
    without memory stats."""
    if not torch.cuda.is_available():
        return []
    usage = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        usage.append({
            "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0)
            / 1e9,
            "bytes_limit_gb": total / 1e9,
            "peak_bytes_gb": stats.get("allocated_bytes.all.peak", 0) / 1e9,
            "free_gb": free / 1e9,
        })
    return usage


def clear_caches() -> None:
    """Drop what the port caches for reuse: the STFT framing tables and
    mel filterbanks of ``ops/stft.py`` (device tensors) and the blocks
    torch's caching allocator holds unused. The built kernel libraries
    stay loaded (the counterpart of ``jax.clear_caches``, which drops
    compiled executables, would be to rebuild them: nothing gains)."""
    from m2tts_tpu_torch.ops import stft

    stft._tables.cache_clear()
    stft.mel_basis.cache_clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


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
