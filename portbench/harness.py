"""What every run shares: the manifest and the files a cell names, the
caches' places, the device's description, the check that nothing of JAX
or of the JAX package is loaded, and the result line."""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: modules no run may hold, compared by whole top-level name (the port's
#: package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "m2tts_tpu")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (from /proc), or
    now where /proc does not say."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def use_checkout_caches(root: Path = ROOT) -> None:
    """Every kernel and build cache at a fixed directory of the checkout.
    The program's own kernels build into ``build/kernels`` there."""
    base = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def manifest(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(man: Dict, name: str) -> Dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> Dict:
    """``portbench/<kind>/<name>.json``: a configuration, a mix or a
    cell's limits."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(modules: Iterable[str] = ()) -> List[str]:
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def device_info(device, peak_bytes: int) -> Dict:
    """What the result line says of the device (one card a run)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def emit(result: Dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line of standard output (``checks`` its last key)."""
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
