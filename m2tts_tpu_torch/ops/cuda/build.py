"""Build, load and probe the port's CUDA kernels.

Every ``m2tts_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for sm_90a into
``build/kernels/lib<name>-<hash of source, shared headers and flags>.so``
at first use and
loaded with ctypes (plain C entry points, no PyTorch headers, so a build
takes seconds). Nothing is built when the package is imported.

``kernels_available()`` is the port of the TPU package's kernel probe
(``Synthesizer._pallas_available``): False without a CUDA device; on a
CUDA device it builds, launches the ``x + 1`` probe and checks it, and
RAISES if either fails, so a broken kernel never turns ``auto`` into the
plain path in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_AVAILABLE: Optional[bool] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel (one
    ``nvcc`` per source); returns {name: library path}. Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    pending = {}
    for name, (src, lib) in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        log = open(lib.with_suffix(".log"), "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT)
        pending[name] = (proc, tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in pending.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (rc {rc}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: lib for name, (_, lib) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "probe":
        lib.m2tts_probe_add_one.argtypes = [p, p, i, p]
        lib.m2tts_probe_add_one.restype = i
    else:  # vocoder_tc (bf16); vocoder_tc32 (f32) adds the tconv's layout
        pre = "m2tts_vocoder_" + name[len("vocoder_"):]
        stage, smem = getattr(lib, pre + "_stage"), getattr(lib, pre + "_smem")
        extra = int(name == "vocoder_tc32")
        stage.argtypes = [p] * 10 + [i] * (16 + 2 * extra) + [p]
        stage.restype = i
        smem.argtypes = [i] * (9 + extra)
        smem.restype = ctypes.c_longlong


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


#: launches of the probe kernel
PROBE_LAUNCHES = 0
_PROBE = None  # the probe's C entry point, bound once


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """y = x + 1 for a contiguous f32 CUDA tensor, by the probe kernel."""
    global PROBE_LAUNCHES, _PROBE
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("probe_add_one takes a contiguous f32 CUDA tensor")
    if _PROBE is None:
        _PROBE = load("probe").m2tts_probe_add_one
    y = torch.empty_like(x)
    # the raw handle of the current stream of x's device, without building
    # a torch.cuda.Stream object
    err = _PROBE(x.data_ptr(), y.data_ptr(), x.numel(),
                 torch._C._cuda_getCurrentRawStream(x.device.index))
    PROBE_LAUNCHES += 1
    check(err, "probe kernel launch")
    return y


def kernels_available() -> bool:
    """False without a CUDA device. With one: builds every kernel, launches
    the probe on an (8, 128) f32 tensor and checks the result; True, or
    raises. The answer is cached."""
    global _AVAILABLE
    if _AVAILABLE is None:
        if not torch.cuda.is_available():
            _AVAILABLE = False
        else:
            build_all()
            x = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
            y = probe_add_one(x)
            torch.cuda.synchronize()
            if not torch.equal(y, torch.ones_like(x)):
                raise RuntimeError("probe kernel returned a wrong result")
            _AVAILABLE = True
    return _AVAILABLE
