"""Device utilities of the PyTorch port (``utils/device.py``) against the
JAX package's: ``get_device_info`` carries every JAX key (plus each CUDA
device's properties), ``hbm_usage`` is one dict a CUDA device with the
JAX keys and ``[]`` without one, as the JAX function is on a backend
without memory stats, and ``clear_caches`` drops the port's caches."""

import numpy as np
import torch

from m2tts_tpu.utils import device as jdevice
from m2tts_tpu_torch.ops import stft
from m2tts_tpu_torch.utils import device

torch.set_num_threads(2)

HBM_KEYS = {"bytes_in_use_gb", "bytes_limit_gb", "peak_bytes_gb"}


def test_device_info_has_the_jax_keys():
    info = device.get_device_info()
    assert set(jdevice.get_device_info()) <= set(info)
    assert info["device_count"] == len(info["devices"])
    if torch.cuda.is_available():
        assert info["backend"] == "cuda"
        props = info["device_properties"]
        assert len(props) == torch.cuda.device_count()
        assert {"name", "total_memory_gb", "sm_count",
                "capability"} <= set(props[0])
    else:
        assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
        assert "device_properties" not in info


def test_hbm_usage():
    usage = device.hbm_usage()
    if not torch.cuda.is_available():
        assert usage == []
        return
    assert len(usage) == torch.cuda.device_count()
    for u in usage:
        assert HBM_KEYS <= set(u)
        assert 0 <= u["bytes_in_use_gb"] <= u["peak_bytes_gb"] \
            <= u["bytes_limit_gb"]


def test_clear_caches_drops_the_stft_tables():
    x = torch.from_numpy(np.random.default_rng(0)
                         .standard_normal((1, 4096)).astype(np.float32))
    stft.log_mel_features(x, n_mels=16)
    assert stft._tables.cache_info().currsize > 0
    assert stft.mel_basis.cache_info().currsize > 0
    device.clear_caches()
    assert stft._tables.cache_info().currsize == 0
    assert stft.mel_basis.cache_info().currsize == 0
    # the caches refill on the next call, to the same values
    ref = stft.log_mel_features(x, n_mels=16)
    device.clear_caches()
    torch.testing.assert_close(stft.log_mel_features(x, n_mels=16), ref,
                               rtol=0, atol=0)

