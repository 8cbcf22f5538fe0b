"""ctypes loader of the C++ mel frontend (``native/mel_frontend.cpp``).

The port's own counterpart of ``m2tts_tpu/frontend/native.py``. The C++ code
computes ``compute_mel_spectrogram`` of ``frontend/audio.py`` (within 2e-5
of the NumPy path, ``tests/test_torch_native.py``) for bulk ingest; ctypes
releases the GIL during the call, so ``compute_mel_batch`` scales over
cores with a plain thread pool.

The library is built with ``g++ -O3 -march=native -fPIC -shared
-std=c++17`` on first use into the git-ignored
``build/native/libmelfrontend-<host>-<source hash>.so``. ``-march=native``
makes it code for the building host's CPU, so the name carries a
fingerprint of that host (machine, CPU flags, boot id): a library built on
another host is never loaded (it could die on an illegal instruction);
the hash rebuilds it after an edit to the source. Nothing is built when
the module is imported. ``native_available()`` is the one gate: False
when the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "mel_frontend.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _host_fingerprint() -> str:
    """Machine, CPU flags and boot id, hashed: a library built with
    ``-march=native`` is valid on this host only."""
    src = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    src += line
                    break
    except OSError:
        src += platform.processor()
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            src += f.read().strip()
    except OSError:
        pass
    return hashlib.sha1(src.encode()).hexdigest()[:12]


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / (f"libmelfrontend-{_host_fingerprint()}-"
                        f"{h.hexdigest()[:16]}.so")


def build_native() -> bool:
    """Compile the library unless it exists; True on success."""
    if not SRC.exists():
        return False
    lib = lib_path()
    if lib.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native mel frontend build failed: %s", e)
        tmp.unlink(missing_ok=True)
        return False
    logger.info("built native mel frontend: %s", lib)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not build_native():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path()))
        except OSError as e:
            logger.warning("native mel frontend load failed: %s", e)
            _load_failed = True
            return None
        lib.mf_num_frames.restype = ctypes.c_int64
        lib.mf_num_frames.argtypes = [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int]
        lib.mf_mel.restype = ctypes.c_int
        lib.mf_mel.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def compute_mel_native(audio: np.ndarray, sample_rate: int = 22050,
                       n_fft: int = 1024, hop_length: int = 256,
                       win_length: int = 1024, n_mels: int = 64,
                       fmin: float = 0.0, fmax: Optional[float] = None
                       ) -> np.ndarray:
    """Audio → normalized log-mel [n_mels, n_frames], as
    ``frontend.audio.compute_mel_spectrogram``. Raises ``ValueError`` for
    audio of at most ``n_fft // 2`` samples (the reflect padding needs
    more) and ``RuntimeError`` when the library is unavailable or fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native mel frontend unavailable")
    audio = np.ascontiguousarray(audio, np.float32)
    if audio.ndim != 1:
        raise ValueError(f"expected mono audio [n], got {audio.shape}")
    n = audio.shape[0]
    n_frames = int(lib.mf_num_frames(n, n_fft, hop_length))
    if n_frames <= 0 or n <= n_fft // 2:
        raise ValueError(f"audio too short: {n} samples")
    out = np.empty((n_mels, n_frames), np.float32)
    rc = lib.mf_mel(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        sample_rate, n_fft, hop_length, win_length, n_mels,
        float(fmin), float(fmax if fmax is not None else 0.0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"mf_mel failed with code {rc}")
    return out


def compute_mel_batch(audios: Sequence[np.ndarray], n_threads: int = 0,
                      **kwargs) -> List[np.ndarray]:
    """``compute_mel_native`` over ``audios`` in a thread pool (the GIL is
    released inside each C call); ``n_threads`` 0 takes one per core."""
    if n_threads <= 0:
        n_threads = min(len(audios), os.cpu_count() or 1)
    if n_threads <= 1:
        return [compute_mel_native(a, **kwargs) for a in audios]
    with ThreadPoolExecutor(n_threads) as pool:
        return list(pool.map(lambda a: compute_mel_native(a, **kwargs),
                             audios))
