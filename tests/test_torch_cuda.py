"""Cases of the PyTorch port that need a CUDA device: the fused vocoder
kernel against its plain version, the kernel probe, and the ``auto``
Synthesizer through the kernel against the ``mm`` backend. They skip
without a card. This file imports no JAX, so on the card it runs without
the test harness's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 atol 3e-5 / rtol 1e-4; bf16 kernel against the bf16 plain
version (same rounding points, other summation order) max abs 2e-2; PCM
within ±1 LSB.
"""

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.models.tts_model import M2TTS, Vocoder, init_params
from m2tts_tpu_torch.ops import vocoder_mm as tmm
from m2tts_tpu_torch.ops.cuda import build
from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder
from m2tts_tpu_torch.serving.pipeline import Synthesizer

torch.set_num_threads(2)

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

F32 = dict(atol=3e-5, rtol=1e-4)
BF16_MAX = 2e-2


@needs_cuda
def test_probe_and_kernels_available():
    assert build.kernels_available() is True
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").view(8, 128)
    before = build.PROBE_LAUNCHES
    assert torch.equal(build.probe_add_one(x), x + 1)
    assert build.PROBE_LAUNCHES == before + 1


@needs_cuda
@pytest.mark.parametrize("rates,channels", [((4, 4, 2, 2), 64),
                                            ((8, 8, 2, 2), 128)],
                         ids=["64x-c64", "256x-c128"])
@pytest.mark.parametrize("shape", [(1, 5), (3, 200)])
def test_kernel_matches_plain(rates, channels, shape):
    voc = init_params(Vocoder(16, channels, 3, rates),
                      torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn((*shape, 16), generator=gen).cuda()
    for cd in ("f32", "bf16"):
        packed = tmm.pack_vocoder_weights(voc, cd)
        before = cuda_vocoder.LAUNCHES
        out = cuda_vocoder.fused_vocoder_forward(mel, packed, rates, cd)
        torch.cuda.synchronize()
        assert cuda_vocoder.LAUNCHES == before + 1
        assert out.shape == (shape[0], shape[1] * int(np.prod(rates)))
        ref = tmm.vocoder_mm_forward(mel, packed, cd)
        if cd == "f32":
            torch.testing.assert_close(out, ref, **F32)
        else:
            assert (out - ref).abs().max() < BF16_MAX


@needs_cuda
def test_auto_synthesizer_runs_the_kernel():
    model = init_params(M2TTS(hidden_dim=32, mel_channels=16,
                              vocoder_channels=32, text_encoder_layers=1,
                              decoder_layers=1),
                        torch.Generator().manual_seed(0), "cuda")
    buckets = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
                   batch_buckets=(1, 2, 4))
    auto = Synthesizer(model, compute_dtype="f32", **buckets)
    mm = Synthesizer(model, compute_dtype="f32", vocoder_backend="mm",
                     **buckets)
    assert auto.vocoder_backend == "cuda"
    texts = ["hello world", "the quick brown fox jumps", "a"]
    before = cuda_vocoder.LAUNCHES
    out = auto.synthesize_batch(texts, duration_scale=12.0)
    assert cuda_vocoder.LAUNCHES == before + 1
    for a, b in zip(out, mm.synthesize_batch(texts, duration_scale=12.0)):
        assert a["frames"] == b["frames"]
        assert np.abs(a["audio_pcm"].astype(np.int32)
                      - b["audio_pcm"]).max(initial=0) <= 1
