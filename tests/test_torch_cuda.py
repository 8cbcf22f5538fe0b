"""Cases of the PyTorch port that need a CUDA device: the fused vocoder
kernels (tensor cores in bf16, 3×TF32 tensor cores in f32) against their
plain versions, whole and stage by stage, at widths 64 to 512 (192 and 512
run the residual convs as several column groups a block), the kernel
probe, and the ``auto`` Synthesizer through the kernels against the ``mm``
backend, and the streaming path on the kernels (streamed against the kernel
run whole, the short path on the f32 kernel, the ``StreamBatcher`` against
solo streams), stage-1 training on the card (one f32 step against the
same step on the CPU with TF32 off, the prefetcher's side-stream copies
bit-equal to their host batches, the device cache) and a reference ``.pt``
served through ``auto``. They skip without a card. This file imports no JAX, so on the card it runs without the test
harness's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 atol 3e-5 / rtol 1e-4; bf16 kernel against the bf16 plain
version (same rounding points, other summation order) max abs 2e-2; PCM
within ±1 LSB in f32, within the bf16 bar scaled to LSB in bf16; a train
step on the card against the CPU (f32, TF32 off): losses rtol 1e-5,
gradients atol 1e-6 + rtol 1e-4, params after 3 updates atol 1e-6.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.data.dataset import (DummyDataset, data_iterator,
                                          make_batches)
from m2tts_tpu_torch.data.prefetch import BatchTransfer, DevicePrefetcher
from m2tts_tpu_torch.models.tts_model import M2TTS, Vocoder, init_params
from m2tts_tpu_torch.ops import vocoder_mm as tmm
from m2tts_tpu_torch.ops.cuda import build
from m2tts_tpu_torch.ops.cuda import vocoder as cuda_vocoder
from m2tts_tpu_torch.serving.pipeline import (Synthesizer,
                                              from_torch_checkpoint)
from m2tts_tpu_torch.serving.stream_batcher import StreamBatcher
from m2tts_tpu_torch.serving.streaming import (StreamingSynthesizer,
                                               StreamingVocoder)
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import to_flax
from m2tts_tpu_torch.utils.torch_compat import reference_state_dict

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


def _counts():
    return {"bf16": cuda_vocoder.LAUNCHES_TC, "f32": cuda_vocoder.LAUNCHES_TC32}


def _held(out, ref, cd):
    if cd == "f32":
        torch.testing.assert_close(out, ref, **F32)
    else:
        assert (out.float() - ref.float()).abs().max() < BF16_MAX


@needs_cuda
@pytest.mark.parametrize("rates,channels", [((4, 4, 2, 2), 64),
                                            ((8, 8, 2, 2), 128),
                                            ((8, 8, 2, 2), 192),
                                            ((8, 8, 2, 2), 512)],
                         ids=["64x-c64", "256x-c128", "256x-c192",
                              "256x-c512"])
@pytest.mark.parametrize("shape", [(1, 5), (3, 200), (1, 1), (2, 7),
                                   (5, 333)])
def test_kernel_matches_plain(rates, channels, shape):
    voc = init_params(Vocoder(16, channels, 3, rates),
                      torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn((*shape, 16), generator=gen).cuda()
    for cd in ("f32", "bf16"):
        packed = tmm.pack_vocoder_weights(voc, cd)
        before = _counts()
        out = cuda_vocoder.fused_vocoder_forward(mel, packed, rates, cd)
        torch.cuda.synchronize()
        after = _counts()
        other = "f32" if cd == "bf16" else "bf16"
        assert after[cd] == before[cd] + len(rates)  # one launch a stage
        assert after[other] == before[other]
        assert out.shape == (shape[0], shape[1] * int(np.prod(rates)))
        _held(out, tmm.vocoder_mm_forward(mel, packed, cd), cd)


@needs_cuda
@pytest.mark.parametrize("shape", [(1, 1), (5, 333)])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_each_stage_matches_plain(cd, shape):
    rates = (8, 8, 2, 2)
    voc = init_params(Vocoder(16, 128, 3, rates),
                      torch.Generator().manual_seed(0), "cuda")
    packed = tmm.pack_vocoder_weights(voc, cd)
    x = torch.randn((*shape, 16), generator=torch.Generator().manual_seed(2)).cuda()
    for i, st in enumerate(packed["stages"]):
        out = cuda_vocoder.fused_vocoder_stage(x, packed, i, cd)
        torch.cuda.synchronize()
        ref = tmm.vocoder_mm_stage(
            x, st, tmm.DTYPES[cd],
            first=packed["input_conv"] if i == 0 else None,
            last=packed["output_conv"] if i == len(rates) - 1 else None)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        _held(out, ref, cd)
        x = ref


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_tc_layout_matches_the_library(cd):
    for channels in (256, 512):
        for st in cuda_vocoder.tc_plan((8, 8, 2, 2), 80, channels, cd):
            assert cuda_vocoder.tc_smem_bytes(st) == st["smem_bytes"]


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_auto_synthesizer_runs_the_kernel(cd):
    model = init_params(M2TTS(hidden_dim=32, mel_channels=16,
                              vocoder_channels=32, text_encoder_layers=1,
                              decoder_layers=1),
                        torch.Generator().manual_seed(0), "cuda")
    buckets = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
                   batch_buckets=(1, 2, 4))
    auto = Synthesizer(model, compute_dtype=cd, **buckets)
    mm = Synthesizer(model, compute_dtype=cd, vocoder_backend="mm",
                     **buckets)
    assert auto.vocoder_backend == "cuda"
    texts = ["hello world", "the quick brown fox jumps", "a"]
    before = _counts()[cd]
    out = auto.synthesize_batch(texts, duration_scale=12.0)
    assert _counts()[cd] > before
    lsb = 1 if cd == "f32" else int(BF16_MAX * 32767) + 1
    for a, b in zip(out, mm.synthesize_batch(texts, duration_scale=12.0)):
        assert a["frames"] == b["frames"]
        assert np.abs(a["audio_pcm"].astype(np.int32)
                      - b["audio_pcm"]).max(initial=0) <= lsb


def _tiny_model(rates=(8, 8, 2, 2)):
    return init_params(M2TTS(hidden_dim=32, mel_channels=16,
                             vocoder_channels=32, text_encoder_layers=1,
                             decoder_layers=1, upsample_rates=rates),
                       torch.Generator().manual_seed(0), "cuda")


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_streaming_on_the_kernel_equals_whole(cd):
    model = _tiny_model()
    sv = StreamingVocoder(model, chunk_frames=32, compute_dtype=cd)
    assert sv.vocoder_backend == "cuda"
    mel = torch.randn((100, 16), generator=torch.Generator().manual_seed(3))
    mel = mel.cuda()
    before = _counts()
    chunks = list(sv.stream(mel))
    after = _counts()
    assert after[cd] > before[cd]
    assert [len(c) for c in chunks] == [n * 256 for n in (32, 32, 32, 4)]
    packed = tmm.pack_vocoder_weights(model.vocoder, cd)
    whole = cuda_vocoder.fused_vocoder_forward(mel[None], packed,
                                               (8, 8, 2, 2), cd)[0].cpu()
    streamed = torch.from_numpy(np.concatenate(chunks))
    _held(streamed, whole, cd)
    plain = StreamingVocoder(model, chunk_frames=32, compute_dtype=cd,
                             vocoder_backend="mm").synthesize(mel)
    _held(streamed, torch.from_numpy(plain), cd)
    padded = torch.cat([mel, torch.zeros_like(mel[:28])])[None]
    dev = np.concatenate(list(sv.stream_device(padded, 100)))
    np.testing.assert_array_equal(dev, streamed.numpy())


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_short_path_launches_the_f32_kernel(cd):
    model = _tiny_model()
    sv = StreamingVocoder(model, chunk_frames=32, compute_dtype=cd)
    mel = torch.randn((30, 16), generator=torch.Generator().manual_seed(4))
    mel = mel.cuda()
    before = _counts()
    out = sv.synthesize(mel)
    after = _counts()
    assert after["f32"] == before["f32"] + 4
    assert after["bf16"] == before["bf16"]
    ref = tmm.vocoder_mm_forward(
        mel[None], tmm.pack_vocoder_weights(model.vocoder, "f32"), "f32")
    torch.testing.assert_close(torch.from_numpy(out), ref[0].cpu(), **F32)


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_stream_batcher_on_cuda_equals_solo(cd):
    ss = StreamingSynthesizer(_tiny_model(), chunk_frames=16, max_frames=128,
                              text_bucket=32, compute_dtype=cd)
    texts = ["hello world", "streaming in batches", "the quick brown fox",
             "a"]
    solo = [np.concatenate(list(ss.stream(t, 12.0))) for t in texts]
    sb = StreamBatcher(ss, max_streams=4, max_wait_ms=200)
    got, errors = [None] * len(texts), []

    def run(i):
        try:
            got[i] = np.concatenate(list(sb.stream(texts[i], 12.0,
                                                   timeout=120)))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(texts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sb.close()
    assert not errors, errors
    assert 0 < sb.chunk_dispatches < sb.chunks_emitted
    for g, s in zip(got, solo):
        assert g.shape == s.shape
        _held(torch.from_numpy(g), torch.from_numpy(s), cd)


@pytest.fixture()
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # True by default
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0)


def _train_config(tmp_path, **training):
    return Config({
        "model": {"text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                                   "num_layers": 1, "num_heads": 2,
                                   "dropout": 0.0},
                  "decoder": {"mel_channels": 8, "num_layers": 1},
                  "vocoder": {"hidden_channels": 32}},
        "training": {"batch_size": 8, "max_steps": 6, "learning_rate": 1e-3,
                     "warmup_steps": 2, "bf16": False, "log_every": 2,
                     "save_every": 100, "validate_every": 100, "seed": 0,
                     "validate_samples": False, **training},
        "data": {"buckets": [[48, 128]], "n_mels": 8},
        "system": {"log_metrics": "jsonl"},
        "paths": {"output_dir": str(tmp_path / "out"),
                  "checkpoint_dir": str(tmp_path / "out/ckpt"),
                  "log_dir": str(tmp_path / "out/logs")}})


@needs_cuda
def test_train_step_on_cuda_matches_cpu(tmp_path, no_tf32):
    ds = DummyDataset(**DS_KW)
    tc = Stage1Trainer(_train_config(tmp_path / "cpu"), dataset=ds,
                       device="cpu")
    tg = Stage1Trainer(_train_config(tmp_path / "gpu"), dataset=ds,
                       device="cuda")
    tg.model.load_state_dict(tc.model.state_dict())
    for batch in list(make_batches(ds, 8, tc.buckets, seed=5))[:3]:
        lc, gc = tc._forward_backward(tc._put(batch))
        lg, gg = tg._forward_backward(tg._put(batch))
        for k in lc:
            np.testing.assert_allclose(lg[k].item(), lc[k].item(), rtol=1e-5,
                                       err_msg=k)
        for name, a, b in zip(tc.param_names, gc, gg):
            torch.testing.assert_close(b.cpu(), a, atol=1e-6, rtol=1e-4,
                                       msg=name)
        tc.optimizer.update(gc)
        tg.optimizer.update(gg)
    for k, v in tc.model.state_dict().items():
        torch.testing.assert_close(tg.model.state_dict()[k].cpu(), v,
                                   atol=1e-6, rtol=0, msg=k)


@needs_cuda
@pytest.mark.parametrize("transfer_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefetched_cuda_batches_equal_host(transfer_dtype):
    """The consumer sleeps on its stream before reading each batch and
    drops it at once, so without the event wait and record_stream a later
    copy could land in (or before) memory still being read."""
    ds = DummyDataset(size=200, mel_dim=80, max_text_length=120,
                      max_mel_length=500, seed=0, hop_length=64)
    host = list(itertools.islice(data_iterator(
        ds, 8, [(64, 256), (128, 512)], seed=0, audio_samples=4096), 50))
    transfer = BatchTransfer("cuda", transfer_dtype)
    pf = DevicePrefetcher(iter(host), transfer.put, 2,
                          ready_fn=transfer.ready)
    copies = []
    try:
        for batch in pf:
            torch.cuda._sleep(2_000_000)
            copies.append({k: v.clone() for k, v in batch.items()})
            del batch
    finally:
        pf.close()
    assert not pf._thread.is_alive() and len(copies) == len(host) == 50
    for h, d in zip(host, copies):
        assert set(d) == {k for k, v in h.items() if v.ndim}
        for k, v in d.items():
            want = torch.from_numpy(h[k])
            if transfer_dtype is not None and k in ("mel", "audio"):
                want = want.to(transfer_dtype)
            assert v.is_cuda and v.dtype == want.dtype
            assert torch.equal(v.cpu(), want), k


@needs_cuda
def test_device_cache_on_cuda(tmp_path):
    t = Stage1Trainer(_train_config(tmp_path, max_steps=12, log_every=4,
                                    device_data_cache=True,
                                    transfer_dtype="bfloat16"),
                      dataset=DummyDataset(**DS_KW), device="cuda")
    first_batch = next(t._device_cached_iterator())
    assert first_batch["mel"].is_cuda
    assert first_batch["mel"].dtype == torch.bfloat16
    first = t.validate()["total_loss"]
    last = t.train()
    assert np.isfinite(last["total_loss"]) and last["hbm_peak_gb"] > 0
    assert t.validate()["total_loss"] < first
    t.close()


@needs_cuda
def test_from_torch_checkpoint_on_cuda_runs_the_kernel(tmp_path):
    model = init_params(M2TTS(hidden_dim=32, mel_channels=16,
                              vocoder_channels=32, text_encoder_layers=1,
                              decoder_layers=1, duration_norm="batch",
                              upsample_rates=(8, 8, 2, 2)),
                        torch.Generator().manual_seed(0), "cpu")
    path = tmp_path / "reference.pt"
    torch.save({"model_state_dict": reference_state_dict(
        to_flax(model.state_dict()), 1, 1, 4), "config": {"model": {
            "text_encoder": {"hidden_dim": 32, "num_layers": 1},
            "decoder": {"mel_channels": 16, "num_layers": 1},
            "vocoder": {"hidden_channels": 32,
                        "upsample_rates": [8, 8, 2, 2]}}}}, path)
    buckets = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
                   batch_buckets=(1, 2, 4))
    auto = from_torch_checkpoint(path, **buckets)
    mm = from_torch_checkpoint(path, vocoder_backend="mm", **buckets)
    assert (auto.vocoder_backend, auto.compute_dtype) == ("cuda", "bf16")
    texts = ["hello world", "the quick brown fox jumps", "a"]
    before = _counts()["bf16"]
    out = auto.synthesize_batch(texts, duration_scale=12.0)
    assert _counts()["bf16"] > before
    lsb = int(BF16_MAX * 32767) + 1
    for a, b in zip(out, mm.synthesize_batch(texts, duration_scale=12.0)):
        assert a["frames"] == b["frames"] > 0
        assert np.abs(a["audio_pcm"].astype(np.int32)
                      - b["audio_pcm"]).max(initial=0) <= lsb
