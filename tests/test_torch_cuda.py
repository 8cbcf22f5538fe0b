"""Cases of the PyTorch port that need a CUDA device: the fused vocoder
kernels (tensor cores in bf16, 3×TF32 tensor cores in f32) against their
plain versions, whole and stage by stage, at widths 64 to 512 (192 and 512
run the residual convs as several column groups a block), the kernel
probe, and the ``auto`` Synthesizer through the kernels against the ``mm``
backend, and the streaming path on the kernels (streamed against the kernel
run whole, the short path on the f32 kernel, the ``StreamBatcher`` against
solo streams), stage-1 training on the card (one f32 step against the
same step on the CPU with TF32 off, the prefetcher's side-stream copies
bit-equal to their host batches, the device cache), a reference ``.pt``
served through ``auto``, and stage 2 on the card (the multi-scale
discriminator's forward and input/weight gradients against the CPU in
f32 and in f64, its phase-packed lowering with each weight-gradient
lowering against f64, and one fused GAN step against the CPU in f32, TF32
off),
and the deployment surface on the card (a ``torch.export`` artifact
exported there against the live ``torch``-backend Synthesizer, ±1 LSB, and
loaded on the CPU against a CPU Synthesizer of the same weights, ±1 LSB;
the synthesize CLI's WAV against ``Synthesizer`` through the kernel,
0 LSB), and a mesh on the card (an NCCL world of one rank: three stage-1
steps on its (1, 1) mesh against the same steps without a mesh, and a
batch through the kernel on the mesh against ``mesh=None``, 0 LSB; on the
same mesh six stage-1 steps and a batch as graph replays against eager),
and the CUDA graphs (``utils/graphs.py``) against ``disable_graphs()`` eager:
the Synthesizer at three duration scales, two text sets, int16 and μ-law
with the mel (equal, and the replays' counted launches equal eager's),
``synthesize_stream`` of three same-bucket batches (each result survives
the next replay), the outputs made on the device and fetched by pinned
copies (every int16 code and μ-law byte against numpy's formulas, a
replay's results byte-equal to the old host formulas with one pinned fetch
a call, ``pcm_only`` making no float32, results surviving later calls,
each copy's event on the outputs' device, and with two cards a
Synthesizer on the second one), ``swap_params`` in both dtypes capturing
no new graph and replaying a fresh Synthesizer's PCM, ``frame_probe='host'`` against
``'device'`` (same buckets, 0 LSB, no graph captured after warmup), a
stream chunk by chunk, the
short path as one graph per length, six f32 stage-1 steps over two buckets under
deterministic algorithms (rtol 1e-6), a capture recording one
``graph.capture`` span and its replays none, and a capture that fails (a
host sync) raising and leaving the runner usable; and the training graphs
against eager under deterministic algorithms (bitwise, or ``NONDET_REL``
where an op warns that it has no deterministic version): the fused GAN
step in both lowerings, with and without spectral norm, in f32 and bf16,
the device-cached step, ``alternate_gd``, k = 2, validation's forward
after steps and after a checkpoint is loaded back, a GAN step whose
capture fails (a host sync) raising, and stage 1 at k = 2 with its eval
step after steps and after a restore. They skip without a card.
This file imports no JAX, so on the card it runs without the test
harness's conftest (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 atol 3e-5 / rtol 1e-4; bf16 kernel against the bf16 plain
version (same rounding points, other summation order) max abs 2e-2; PCM
within ±1 LSB in f32, within the bf16 bar scaled to LSB in bf16; a train
step on the card against the CPU (f32, TF32 off): losses rtol 1e-5,
gradients atol 1e-6 + rtol 1e-4, params after 3 updates atol 1e-6; the
discriminator's outputs and gradients within 1e-4 of each tensor's largest
value, of the CPU's f32 and of f64 (``DISC_F64_REL``); a GAN step's losses
rtol 1e-5 and its params within lr/10.
"""

import contextlib
import itertools
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from m2tts_tpu_torch.data.dataset import (DummyDataset, data_iterator,
                                          make_batches)
from m2tts_tpu_torch.data.prefetch import BatchTransfer, DevicePrefetcher
from m2tts_tpu_torch.models.discriminator import MultiScaleDiscriminator
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
from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.params import to_flax
from m2tts_tpu_torch.utils.torch_compat import reference_state_dict

from host_formulas import host_formulas, same_results

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


def _tiny_model(rates=(8, 8, 2, 2), seed=0):
    return init_params(M2TTS(hidden_dim=32, mel_channels=16,
                             vocoder_channels=32, text_encoder_layers=1,
                             decoder_layers=1, upsample_rates=rates),
                       torch.Generator().manual_seed(seed), "cuda")


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


# cuDNN's f32 reductions over time in the discriminator's weight gradients
# land up to 2.6e-5 (of the tensor's largest value) from f64 on an H100,
# and 2.7e-5 from the CPU's f32 (the CPU's f32: 1.5e-6 from f64)
DISC_F64_REL = 1e-4


def _rel_max(got, want):
    return ((got.cpu() - want).abs().max() / want.abs().max()).item()


@needs_cuda
def test_discriminator_on_cuda_matches_cpu(no_tf32):
    """Logits, the 18 feature maps, the input gradient and every weight
    gradient of the spectral-normed discriminator on the card, held against
    the same computation on the CPU in f32 and in f64."""
    d = init_params(MultiScaleDiscriminator(spectral_norm=True),
                    torch.Generator().manual_seed(0), "cpu")
    dg = MultiScaleDiscriminator(spectral_norm=True).cuda()
    dg.load_state_dict(d.state_dict())
    x = torch.randn((2, 4102), generator=torch.Generator().manual_seed(1))

    def run(net, xi):
        xi = xi.requires_grad_(True)
        logits, feats = net(xi)
        scalar = (sum((l ** 2).sum() for l in logits)
                  + sum(f.abs().mean() for fs in feats for f in fs))
        grads = torch.autograd.grad(scalar, [xi, *net.parameters()])
        return [*logits, *(f for fs in feats for f in fs), *grads]

    card, cpu = run(dg, x.cuda()), run(d, x.clone())
    f64 = run(d.double(), x.double())
    assert len(f64) == 3 + 18 + 1 + len(list(d.parameters()))
    for got, a, b in zip(card, cpu, f64):
        assert got.is_cuda and got.dtype == torch.float32
        assert _rel_max(got.double(), b) < DISC_F64_REL
        assert _rel_max(got, a) < DISC_F64_REL


@needs_cuda
@pytest.mark.parametrize("wgrad", ["xla", "pergroup", "dense"])
def test_packed_discriminator_on_cuda_matches_f64(no_tf32, wgrad):
    """The phase-packed lowering (``packed_multiscale_apply``, each
    weight-gradient lowering) on the card: logits, feature maps, input and
    weight gradients against the module in f64 on the CPU, at
    ``DISC_F64_REL``."""
    from m2tts_tpu_torch.models.discriminator import packed_multiscale_apply

    d = init_params(MultiScaleDiscriminator(), torch.Generator().manual_seed(0),
                    "cpu")
    x = torch.randn((2, 4096), generator=torch.Generator().manual_seed(1))

    def run(apply, params, xi):
        xi = xi.requires_grad_(True)
        logits, feats = apply(params, xi)
        scalar = (sum((l ** 2).sum() for l in logits)
                  + sum(f.abs().mean() for fs in feats for f in fs))
        grads = torch.autograd.grad(scalar, [xi, *params.values()])
        return [*logits, *(f for fs in feats for f in fs), *grads]

    card = run(lambda p, xi: packed_multiscale_apply(p, xi, wgrad=wgrad),
               {k: v.detach().cuda().requires_grad_()
                for k, v in d.named_parameters()}, x.cuda())
    d64 = d.double()
    f64 = run(lambda p, xi: torch.func.functional_call(d64, p, (xi,)),
              {k: v.detach().requires_grad_()
               for k, v in d64.named_parameters()}, x.double())
    assert len(card) == len(f64) == 3 + 18 + 1 + 3 * 14
    for got, want in zip(card, f64):
        assert got.is_cuda and got.dtype == torch.float32
        assert _rel_max(got.double(), want) < DISC_F64_REL


def _stage2_config(tmp_path):
    cfg = _train_config(tmp_path, audio_segment_len=2048,
                        discriminator_spectral_norm=True,
                        envelope_loss_weight=4.0, stft_phase_weight=0.0,
                        adaptive_adv_dloss_floor=2.0, adaptive_d_lr_floor=2.0,
                        ema_decay=0.5, lr_scheduler="constant",
                        warmup_steps=0)
    cfg.set("data.hop_length", 256)
    return cfg


@needs_cuda
def test_gan_step_on_cuda_matches_cpu(tmp_path, no_tf32):
    ds = DummyDataset(**DS_KW, keep_audio=True)
    tr = {dev: Stage2Trainer(_stage2_config(tmp_path / dev), dataset=ds,
                             device=dev) for dev in ("cpu", "cuda")}
    tr["cuda"].model.load_state_dict(tr["cpu"].model.state_dict())
    tr["cuda"].discriminator.load_state_dict(
        tr["cpu"].discriminator.state_dict())
    for e, p in zip(tr["cuda"].ema, tr["cuda"].g_params):
        e.data.copy_(p)
    host = next(make_batches(ds, 8, tr["cpu"].buckets, seed=5,
                             audio_samples=128 * 256))
    host = tr["cpu"]._prepare(host, np.random.default_rng(5))
    for _ in range(2):
        mc, mg = (tr[d].train_step(dict(host)) for d in ("cpu", "cuda"))
        assert set(mc) == set(mg) and "adv_guard" in mg
        for k in mc:
            np.testing.assert_allclose(mg[k].item(), mc[k].item(), rtol=1e-5,
                                       err_msg=k)
    for net in ("model", "discriminator"):
        want = getattr(tr["cpu"], net).state_dict()
        for k, v in getattr(tr["cuda"], net).state_dict().items():
            torch.testing.assert_close(v.cpu(), want[k], atol=1e-4, rtol=0,
                                       msg=f"{net} {k}")
    for t in tr.values():
        t.close()


# -- the deployment surface on the card ---------------------------------------

_EXPORT_BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
                       batch_buckets=(1, 2))
_TEXTS = ["hello world", "the quick brown fox jumps"]


@pytest.fixture(scope="module")
def exported_on_cuda(tmp_path_factory):
    """A tiny model, its live ``torch``-backend Synthesizers on the card,
    and an artifact of each dtype exported there for cuda and cpu."""
    from m2tts_tpu_torch.serving.export import export_synthesizer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _tiny_model()
    root = tmp_path_factory.mktemp("export_cuda")
    live = {}
    for cd in ("f32", "bf16"):
        live[cd] = Synthesizer(model, compute_dtype=cd,
                               vocoder_backend="torch", **_EXPORT_BUCKETS)
        export_synthesizer(live[cd], root / cd, full=True,
                           platforms=("cuda", "cpu"))
    return model, live, root


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_exported_on_cuda_matches_live(exported_on_cuda, cd):
    from m2tts_tpu_torch.serving.export import ExportedSynthesizer

    _, live, root = exported_on_cuda
    ex = ExportedSynthesizer(root / cd)
    assert ex.device.type == "cuda"
    for scale in (1.0, 12.0):
        for a, b in zip(live[cd].synthesize_batch(_TEXTS, scale),
                        ex.synthesize_batch(_TEXTS, scale)):
            assert a["frames"] == b["frames"]
            assert np.abs(a["audio_pcm"].astype(np.int32)
                          - b["audio_pcm"]).max(initial=0) <= 1


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_exported_on_cuda_runs_on_cpu(exported_on_cuda, cd):
    import copy

    from m2tts_tpu_torch.serving.export import ExportedSynthesizer

    model, _, root = exported_on_cuda
    ex = ExportedSynthesizer(root / cd, device="cpu")
    assert all(v.device.type == "cpu" for v in ex.params.values())
    cpu = Synthesizer(copy.deepcopy(model).cpu(), compute_dtype=cd,
                      vocoder_backend="torch", device="cpu",
                      **_EXPORT_BUCKETS)
    for a, b in zip(cpu.synthesize_batch(_TEXTS, 12.0),
                    ex.synthesize_batch(_TEXTS, 12.0)):
        assert a["frames"] == b["frames"] > 0
        assert np.abs(a["audio_pcm"].astype(np.int32)
                      - b["audio_pcm"]).max(initial=0) <= 1


@needs_cuda
def test_synthesize_cli_on_cuda_matches_synthesizer(tmp_path):
    import wave

    from m2tts_tpu_torch.frontend.audio import save_wav
    from m2tts_tpu_torch.serving import synthesize
    from m2tts_tpu_torch.serving.pipeline import from_checkpoint
    from m2tts_tpu_torch.utils.checkpoint import CheckpointManager

    model = _tiny_model()
    CheckpointManager(tmp_path / "ckpt").save(1, {
        "params": {k: v.cpu() for k, v in model.state_dict().items()},
        "step": 1}, config={"model": {
            "text_encoder": {"hidden_dim": 32, "num_layers": 1},
            "decoder": {"mel_channels": 16, "num_layers": 1},
            "vocoder": {"hidden_channels": 32,
                        "upsample_rates": [8, 8, 2, 2]}}})

    def read(path):
        with wave.open(str(path), "rb") as f:
            return np.frombuffer(f.readframes(f.getnframes()), "<i2")

    before = _counts()["bf16"]
    assert synthesize.main(["--text", _TEXTS[1], "--checkpoint",
                            str(tmp_path / "ckpt"), "--duration-scale", "12",
                            "--output", str(tmp_path / "cli.wav")]) == 0
    assert _counts()["bf16"] > before  # auto: bf16 on vocoder_tc.cu
    synth = from_checkpoint(tmp_path / "ckpt")
    assert (synth.vocoder_backend, synth.compute_dtype) == ("cuda", "bf16")
    ref = synth.synthesize(_TEXTS[1], 12.0)
    assert ref["frames"] > 0
    save_wav(ref["audio"], tmp_path / "ref.wav")
    np.testing.assert_array_equal(read(tmp_path / "cli.wav"),
                                  read(tmp_path / "ref.wav"))


def _nccl_world(out):
    """One NCCL rank: three stage-1 steps on the (1, 1) mesh that
    ``system.mesh`` gives under a process group, and a sharded batch
    through the kernel."""
    from m2tts_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = Stage1Trainer(_train_config(Path(out)),
                      dataset=DummyDataset(**DS_KW), device="cuda")
    assert t.mesh is not None and t.mesh.mesh.shape == (1, 1)
    losses = [{k: v.item() for k, v in t._train_step(t._put(b)).items()}
              for b in list(make_batches(t.dataset, 8, t.buckets, seed=5))[:3]]
    params = t._host_state_copy()["params"]
    synth = Synthesizer(_tiny_model(), mesh=make_mesh(device_type="cuda"),
                        **MESH_BUCKETS)
    before = _counts()["bf16"]
    out = synth.synthesize_batch(MESH_TEXTS, duration_scale=12.0)
    return losses, params, [(r["frames"], r["audio_pcm"]) for r in out], \
        _counts()["bf16"] - before


MESH_BUCKETS = dict(text_buckets=(32,), frame_buckets=(128,),
                    batch_buckets=(4,))
MESH_TEXTS = ["hello world", "the quick brown fox jumps", "a"]


@needs_cuda
def test_nccl_mesh_of_one_equals_no_mesh(tmp_path, no_tf32):
    from m2tts_tpu_torch.parallel.mesh import spawn_world

    t = Stage1Trainer(_train_config(tmp_path / "plain"),
                      dataset=DummyDataset(**DS_KW), device="cuda")
    want = [{k: v.item() for k, v in t._train_step(t._put(b)).items()}
            for b in list(make_batches(t.dataset, 8, t.buckets, seed=5))[:3]]
    losses, params, out, launches = spawn_world(
        _nccl_world, 1, args=(str(tmp_path / "mesh"),), backend="nccl",
        device="cuda", workdir=str(tmp_path))[0]
    for got, ref in zip(losses, want):
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    for k, v in t._host_state_copy()["params"].items():
        torch.testing.assert_close(params[k], v, atol=1e-6, rtol=0, msg=k)
    assert launches > 0
    ref = Synthesizer(_tiny_model(), **MESH_BUCKETS).synthesize_batch(
        MESH_TEXTS, duration_scale=12.0)
    for (frames, pcm), r in zip(out, ref):
        assert frames == r["frames"] > 0
        np.testing.assert_array_equal(pcm, r["audio_pcm"])


# -- CUDA graphs (utils/graphs.py): replay against disable_graphs() eager --

GRAPH_BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
                     batch_buckets=(1, 2, 4))
GRAPH_TEXTS = (["hello world", "the quick brown fox jumps", "a"],
               ["streaming in batches", "hello there", "one more"])


def _synth_out(s, texts, scale, **kw):
    return [(r["frames"], r["audio_pcm"], r.get("audio_mulaw"),
             r.get("mel")) for r in s.synthesize_batch(texts, scale, **kw)]


def _same_out(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_synthesizer_graphs_equal_eager(cd):
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    s = Synthesizer(_tiny_model(), compute_dtype=cd, **GRAPH_BUCKETS)
    for texts in GRAPH_TEXTS:
        for scale in (4.8, 6.0, 7.8):
            for kw in ({}, {"pcm_format": "mulaw", "want_mel": True}):
                with disable_graphs():
                    before = _counts()[cd]
                    want = _synth_out(s, texts, scale, **kw)
                    eager_launches = _counts()[cd] - before
                _synth_out(s, texts, scale, **kw)  # eager + capture
                before = _counts()[cd]
                got = _synth_out(s, texts, scale, **kw)  # replays
                assert _counts()[cd] - before == eager_launches
                _same_out(got, want)
    stats = s.graph_stats()
    # the probe, int16 and μ-law + mel graphs of each bucket reached
    assert stats["graphs"] >= 3 and stats["replays"] > 0


@needs_cuda
def test_synthesize_stream_results_survive_the_next_replay():
    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    batches = [["hello world"], ["the world"], ["hello there"]]
    s.synthesize_batch(batches[0], 12.0)  # capture the bucket
    streamed = list(s.synthesize_stream(iter(batches), 12.0))
    for got, texts in zip(streamed, batches):
        _same_out([(r["frames"], r["audio_pcm"]) for r in got],
                  [(r["frames"], r["audio_pcm"])
                   for r in s.synthesize_batch(texts, 12.0)])


# -- outputs made on the device, fetched by pinned copies --------------------

#: at STAGE_SCALE the last text passes the largest frame bucket (140 > 128
#: frames by the f32 probe), the others fit
STAGE_TEXTS = GRAPH_TEXTS[0] + ["the quick brown fox jumps over the lazy "
                                "dog again and again"]
STAGE_SCALE = 9.0


def _fetched_bytes(out, pcm_only):
    """What one call's pinned copies carry: each output and, unless
    ``pcm_only``, the μ-law decode and the float32 waveform."""
    n = out["pcm"].numel()
    made = 0 if pcm_only else (
        n * 2 * (out["pcm"].dtype == torch.uint8) + n * 4)
    return made + sum(v.numel() * v.element_size() for v in out.values())


@needs_cuda
@pytest.mark.parametrize("want_mel", [False, True], ids=["pcm", "mel"])
@pytest.mark.parametrize("pcm_format", ["int16", "mulaw"])
def test_device_outputs_equal_the_host_formulas_on_cuda(pcm_format,
                                                         want_mel):
    """On the card: the results made on the device, fetched by pinned
    copies and sliced, against the old host formulas on the same launch's
    outputs (graph replays); each call counts one pinned fetch of its
    outputs' bytes."""
    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    s.synthesize_batch(STAGE_TEXTS, STAGE_SCALE, want_mel=want_mel,
                       pcm_format=pcm_format)  # capture
    n = len(STAGE_TEXTS)
    fetches, nbytes = s.pinned_fetches, s.fetched_bytes
    out, frames = s._launch(STAGE_TEXTS, STAGE_SCALE, None, want_mel,
                            pcm_format)
    want = host_formulas(s, out, frames, n, want_mel, False)
    got = s._collect(out, frames, n, want_mel)
    assert [bool(r.get("truncated")) for r in got] == [False] * 3 + [True]
    same_results(got, want)
    assert (s.pinned_fetches, s.fetched_bytes) == \
        (fetches + 1, nbytes + _fetched_bytes(out, False))
    for r in got:
        assert r["audio"].tobytes() == (
            r["audio_pcm"].astype(np.float32) / 32767.0).tobytes()


@needs_cuda
@pytest.mark.parametrize("pcm_format", ["int16", "mulaw"])
def test_stream_pcm_only_makes_no_float32_on_cuda(pcm_format):
    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    batches = [STAGE_TEXTS[:2], STAGE_TEXTS[2:]]
    want = [s.synthesize_batch(t, STAGE_SCALE, pcm_format=pcm_format)
            for t in batches]
    fetches = s.pinned_fetches
    streamed = list(s.synthesize_stream(iter(batches), STAGE_SCALE,
                                        pcm_only=True,
                                        pcm_format=pcm_format))
    assert s.pinned_fetches == fetches + 2
    key = "audio_mulaw" if pcm_format == "mulaw" else "audio_pcm"
    for got, ref in zip(streamed, want):
        for g, w in zip(got, ref):
            assert "audio" not in g
            assert ("audio_pcm" in g) is (pcm_format == "int16")
            assert g[key].tobytes() == w[key].tobytes()
            assert g["frames"] == w["frames"]


@needs_cuda
def test_results_survive_later_calls_on_cuda():
    """A call's arrays, views of its own pinned host tensors, keep their
    bytes through later calls in the same buckets (which reuse freed
    blocks)."""
    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    first = s.synthesize_batch(STAGE_TEXTS, STAGE_SCALE, want_mel=True)
    kept = [{k: v.copy() for k, v in r.items()
             if isinstance(v, np.ndarray)} for r in first]
    for _ in range(3):
        s.synthesize_batch(["a different text", "other words here", "b",
                            "yet another sentence to say aloud now"],
                           STAGE_SCALE, want_mel=True)
    for r, k in zip(first, kept):
        for name, v in k.items():
            assert r[name].tobytes() == v.tobytes(), name


@needs_cuda
def test_conversion_is_exact_on_every_code_on_cuda():
    """The device's float32 and μ-law decode over all 65,536 int16 codes
    and all 256 μ-law bytes against numpy's formulas: division by a device
    tensor is IEEE division, where a host scalar divisor would be a
    product with its reciprocal."""
    from m2tts_tpu_torch.ops.audio_codec import MULAW_DECODE_TABLE
    from m2tts_tpu_torch.serving.pipeline import _Launched

    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    codes = np.arange(-32768, 32768).astype(np.int16)
    for pcm, decoded in ((codes, codes),
                         (np.arange(256, dtype=np.uint8),
                          MULAW_DECODE_TABLE)):
        out = _Launched(pcm=torch.from_numpy(pcm.copy())[None].cuda(),
                        total_frames=torch.zeros(1, dtype=torch.int32,
                                                 device="cuda"))
        s._stage(out, pcm_only=False)
        host = s._fetch(out)
        if pcm.dtype == np.uint8:
            assert host["audio_pcm"][0].tobytes() == decoded.tobytes()
        assert host["audio"][0].tobytes() == (
            decoded.astype(np.float32) / 32767.0).tobytes()
    assert s.pinned_fetches == 2


@needs_cuda
def test_pinned_copies_wait_on_the_synthesizers_device(monkeypatch):
    """Every copy's event is recorded on the current stream of the device
    the outputs are on, asked for by that device: an event on the current
    device's stream would complete before a second card's copy."""
    s = Synthesizer(_tiny_model(), **GRAPH_BUCKETS)
    out, _ = s._launch(STAGE_TEXTS, STAGE_SCALE, None, True, "mulaw",
                       to_host=False)
    asked, current_stream = [], torch.cuda.current_stream

    def spy(device=None):
        asked.append(device)
        return current_stream(device)

    monkeypatch.setattr(torch.cuda, "current_stream", spy)
    s._stage(out, pcm_only=False)
    dev = out["pcm"].device
    assert (dev.type, dev.index or 0) == (
        s.device.type, s.device.index or 0)
    assert sorted(out.fetches) == ["audio", "audio_pcm", "mel", "pcm",
                                   "total_frames"]
    assert [ev.device for _, ev in out.fetches.values()] == [dev] * 5
    assert asked == [dev] * 5
    s._fetch(out)


@pytest.mark.skipif("torch.cuda.device_count() < 2",
                    reason="needs two CUDA devices")
@pytest.mark.parametrize("pcm_format", ["int16", "mulaw"])
def test_a_second_cards_results_reach_the_host(pcm_format):
    """A Synthesizer on cuda:1 while cuda:0 is current: each call's results,
    copied out the moment ``_collect`` returns them, equal the host
    formulas on the same launch's outputs, call after call. A spin kernel
    queued first (and no probe, whose fetch would wait it out) keeps the
    second card busy well past any wait that does not wait on it."""
    from m2tts_tpu_torch.serving.pipeline import own_rows

    assert torch.cuda.current_device() == 0
    s = Synthesizer(_tiny_model(), device="cuda:1", **GRAPH_BUCKETS)
    n = len(STAGE_TEXTS)
    for _ in range(4):  # eager, capture, replays
        with torch.cuda.device(1):
            torch.cuda._sleep(100_000_000)
        out, frames = s._launch(STAGE_TEXTS, STAGE_SCALE, 128, True,
                                pcm_format)
        got = own_rows(s._collect(out, frames, n, True))
        same_results(got, host_formulas(s, out, frames, n, True, False))
    assert torch.cuda.current_device() == 0


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_swap_params_keeps_the_graphs(cd):
    """A swap writes the weights into the tensors the graphs read (the
    model's, the bf16 copy's, the packed weights and the kernels'
    operands): no graph is captured after it, and the replays give a fresh
    Synthesizer's PCM (0 LSB); swapping back gives the first weights'."""
    s = Synthesizer(_tiny_model(), compute_dtype=cd, **GRAPH_BUCKETS)
    texts = GRAPH_TEXTS[0]
    s.synthesize_batch(texts, 12.0)  # eager + capture
    first = _synth_out(s, texts, 12.0)  # a replay
    graphs = s.graph_stats()["graphs"]
    other = _tiny_model(seed=1)
    s.swap_params(other.state_dict())
    fresh = Synthesizer(other, compute_dtype=cd, **GRAPH_BUCKETS)
    for _ in range(2):
        _same_out(_synth_out(s, texts, 12.0), _synth_out(fresh, texts, 12.0))
    s.swap_params(_tiny_model().state_dict())
    _same_out(_synth_out(s, texts, 12.0), first)
    assert s.graph_stats()["graphs"] == graphs


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_host_frame_probe_equals_device(cd):
    """``frame_probe='host'`` (the f32 probe on a CPU copy) routes these
    requests to the device probe's bucket (host counts + 2), and its replays
    give the device-probe Synthesizer's PCM (0 LSB); after ``warmup(full=
    True)`` its calls capture no graph."""
    from m2tts_tpu_torch.serving import pipeline

    model = _tiny_model()
    host = Synthesizer(model, compute_dtype=cd, frame_probe="host",
                       **GRAPH_BUCKETS)
    device = Synthesizer(model, compute_dtype=cd, **GRAPH_BUCKETS)
    host.warmup(full=True)
    graphs = host.graph_stats()["graphs"]
    for texts in GRAPH_TEXTS:
        packed = pipeline.encode_packed_batch(
            host.text_processor, texts, host.batch_buckets, host.text_buckets)
        for scale in (4.8, 6.0, 7.8):
            h = host.predict_frames_host(packed[:, :-1], packed[:, -1], scale)
            d = device.predict_frames(packed[:, :-1], packed[:, -1], scale)
            n = len(texts)
            assert pipeline._bucket_for(
                int(h[:n].max()) + pipeline.HOST_PROBE_GUARD,
                host.frame_buckets) == pipeline._bucket_for(
                int(d[:n].max()), host.frame_buckets)
            _same_out(_synth_out(host, texts, scale),
                      _synth_out(device, texts, scale))
    assert host.graph_stats()["graphs"] == graphs


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_streaming_graphs_equal_eager(cd):
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    ss = StreamingSynthesizer(_tiny_model(), chunk_frames=16, max_frames=128,
                              text_bucket=32, compute_dtype=cd)
    text = "the quick brown fox jumps over the lazy dog"
    with disable_graphs():
        want = list(ss.stream(text, 12.0))
    for _ in range(2):  # eager + capture, then replays
        got = list(ss.stream(text, 12.0))
        assert len(got) == len(want) > 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert len(ss.graphs) == 1 and len(ss.vocoder.graphs) == 1


@needs_cuda
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_short_path_is_one_graph_per_length(cd):
    """Three lengths no longer than the window, each streamed twice: three
    graphs in the vocoder's runner (a first call, then a replay), each
    output bitwise the eager one."""
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    sv = StreamingVocoder(_tiny_model(), chunk_frames=32, compute_dtype=cd)
    gen = torch.Generator().manual_seed(5)
    mels = [torch.randn((T, 16), generator=gen).cuda() for T in (7, 30, 40)]
    with disable_graphs():
        want = [sv.synthesize(m) for m in mels]
    for _ in range(2):
        for m, w in zip(mels, want):
            np.testing.assert_array_equal(sv.synthesize(m), w)
    assert sv.graphs.stats() == {"graphs": 3, "replays": 3}


@needs_cuda
def test_capture_runs_with_the_collector_paused():
    """A key's first call runs its function eagerly with Python's cyclic
    collector on, then captures it with the collector off (a cycle freed
    inside a capture may hold another runner's graph, whose destruction
    would invalidate the capture); a replay runs no Python."""
    import gc

    from m2tts_tpu_torch.utils.graphs import GraphRunner

    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x * 2

    runner = GraphRunner("cuda")
    x = torch.ones(4, device="cuda")
    for _ in range(2):
        torch.testing.assert_close(runner(("k",), fn, x), x * 2)
    assert seen == [True, False] and gc.isenabled()


@needs_cuda
def test_capture_is_one_span_and_replays_none():
    """While tracing is on, a key's capture (its eager run included) is
    one ``graph.capture`` span named by the key; its replays record no
    span."""
    from m2tts_tpu_torch.utils import profiling
    from m2tts_tpu_torch.utils.graphs import GraphRunner

    runner = GraphRunner("cuda")
    x = torch.ones(4, device="cuda")
    profiling.drain()
    profiling.enable()
    try:
        runner(("k",), lambda t: t * 2, x)
        captured = profiling.drain()
        for _ in range(3):
            torch.testing.assert_close(runner(("k",), lambda t: t * 2, x),
                                       x * 2)
        replayed = profiling.drain()
    finally:
        profiling.disable()
        profiling.drain()
    assert [s[:2] for s in captured] == [
        ("graph.capture", (("k",), (((4,), torch.float32),)))]
    assert replayed == [] and runner.stats()["replays"] == 3


@needs_cuda
def test_failed_capture_raises_and_leaves_the_stream_usable():
    from m2tts_tpu_torch.utils.graphs import GraphRunner

    runner = GraphRunner("cuda")
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        runner(("sync",), lambda t: t * float(t.sum().item()), x)
    assert len(runner) == 0
    for _ in range(2):
        assert torch.equal(runner(("ok",), lambda t: t * 2, x), x * 2)
    assert len(runner) == 1


def _graph_trainer(tmp_path, graphed: bool):
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    cfg = _train_config(tmp_path, gradient_clip_norm=0.5)
    cfg.set("model.text_encoder.dropout", 0.1)
    cfg.set("data.buckets", [[24, 64], [48, 128]])
    t = Stage1Trainer(cfg, dataset=DummyDataset(**DS_KW), device="cuda")
    batches = list(make_batches(t.dataset, 8, t.buckets, seed=5))[:6]
    losses = []
    with contextlib.nullcontext() if graphed else disable_graphs():
        for b in batches:
            losses.append({k: v.item() for k, v in
                           t._guarded_step(t._put(b)).items()})
            t.step += 1
    return t, losses


@pytest.fixture()
def deterministic(monkeypatch):
    """Deterministic algorithms: without them two eager runs part too (the
    backward's atomics round differently run to run, and Adam moves a
    weight whose gradient is rounding noise by ±lr a step)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _nccl_graph_world(out):
    """One NCCL rank, deterministic algorithms: ``_graph_trainer``'s six
    steps on the (1, 1) mesh eagerly and as graphs (which hold the mesh's
    all-reduces), and a batch on a mesh Synthesizer eagerly and replayed."""
    from m2tts_tpu_torch.parallel.mesh import make_mesh
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    res = {}
    for name, graphed in (("eager", False), ("graph", True)):
        t, losses = _graph_trainer(Path(out) / name, graphed)
        assert t.mesh is not None and t._graphs is not None
        res[name] = (losses, {k: v.cpu() for k, v in
                              t._host_state_copy()["params"].items()},
                     t._graphs.stats() if graphed else None)
        t.close()
    synth = Synthesizer(_tiny_model(), mesh=make_mesh(device_type="cuda"),
                        **MESH_BUCKETS)
    with disable_graphs():
        res["synth_eager"] = _synth_out(synth, MESH_TEXTS, 12.0)
    res["synth_graph"] = [_synth_out(synth, MESH_TEXTS, 12.0)
                          for _ in range(2)]
    res["synth_stats"] = synth.graph_stats()
    return res


@needs_cuda
def test_nccl_mesh_graphs_equal_eager(tmp_path, no_tf32, deterministic):
    """On an NCCL mesh (one rank) the stage-1 step and the Synthesizer are
    graph replays, held to their eager runs as without a mesh."""
    from m2tts_tpu_torch.parallel.mesh import spawn_world

    res = spawn_world(_nccl_graph_world, 1, args=(str(tmp_path / "w"),),
                      backend="nccl", device="cuda",
                      workdir=str(tmp_path))[0]
    (le, pe, _), (lg, pg, stats) = res["eager"], res["graph"]
    # each bucket's first step captures, the others replay
    assert stats["graphs"] >= 1 and stats["graphs"] + stats["replays"] == 6
    for a, b in zip(le, lg):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    for k, v in pe.items():
        torch.testing.assert_close(pg[k], v, atol=1e-6, rtol=1e-6, msg=k)
    for got in res["synth_graph"]:
        _same_out(got, res["synth_eager"])
    assert res["synth_stats"]["graphs"] == 2  # the probe, the synthesis
    assert res["synth_stats"]["replays"] == 2


@needs_cuda
def test_train_step_graph_equals_eager(tmp_path, no_tf32, deterministic):
    eager, le = _graph_trainer(tmp_path / "eager", graphed=False)
    graph, lg = _graph_trainer(tmp_path / "graph", graphed=True)
    assert graph._graphs.stats()["replays"] > 0
    assert graph.optimizer.count == eager.optimizer.count == 6
    for a, b in zip(le, lg):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    for k, v in eager.model.state_dict().items():
        torch.testing.assert_close(graph.model.state_dict()[k], v,
                                   atol=1e-6, rtol=1e-6, msg=k)


# -- the training graphs: GAN step, accumulation, validation ---------------

#: where an op of the step has no deterministic CUDA version (a warning of
#: ``use_deterministic_algorithms(True, warn_only=True)`` names it), graph
#: and eager are held to this relative bar, each tensor against its largest
#: value, instead of bitwise
NONDET_REL = 1e-5


@pytest.fixture()
def nondet_ops(monkeypatch):
    """Deterministic algorithms where they exist; yields the list of the
    ops that warned that they have none."""
    import warnings

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield seen
        seen.extend(sorted({str(w.message).split(" does not have")[0]
                            for w in caught
                            if "deterministic" in str(w.message)}))
    torch.use_deterministic_algorithms(False)


def _held_graph(got, want, nondet, what):
    """``got`` (graph) against ``want`` (eager): bitwise, or within
    ``NONDET_REL`` where ``nondet`` names ops without a deterministic
    version."""
    if not nondet:
        assert torch.equal(got, want), f"{what}: not bitwise equal"
        return
    scale = want.abs().max().clamp_min(1e-30)
    rel = float((got - want).abs().max() / scale)
    assert rel <= NONDET_REL, f"{what}: {rel} (nondeterministic: {nondet})"


def _gan_config(tmp_path, **training):
    cfg = _train_config(tmp_path, audio_segment_len=2048,
                        stft_phase_weight=0.0, lr_scheduler="constant",
                        warmup_steps=0, validate_quality=False, **training)
    cfg.set("data.hop_length", 256)
    cfg.set("model.text_encoder.dropout", 0.1)
    cfg.set("data.buckets", GRAPH_TRAIN_BUCKETS)
    return cfg


#: two buckets that the tiny dataset of ``GRAPH_DS_KW`` fills at least four
#: batches of 8 each
GRAPH_TRAIN_BUCKETS = [[48, 96], [48, 128]]
GRAPH_DS_KW = {**DS_KW, "size": 128}


def _gan_pair(tmp_path, **training):
    ds = DummyDataset(**GRAPH_DS_KW, keep_audio=True)
    tr = {m: Stage2Trainer(_gan_config(tmp_path / m, **training), dataset=ds,
                           device="cuda") for m in ("eager", "graph")}
    tr["graph"].model.load_state_dict(tr["eager"].model.state_dict())
    tr["graph"].discriminator.load_state_dict(
        tr["eager"].discriminator.state_dict())
    if tr["graph"].ema is not None:
        for e, p in zip(tr["graph"].ema, tr["graph"].g_params):
            e.data.copy_(p)
    return tr


def _gan_batches(t, per_bucket, cached):
    """``per_bucket`` device batches of each bucket of ``t``, bucket by
    bucket: host segments, or (``cached``) device-cached whole waveforms."""
    if cached:
        source = itertools.islice(t._device_cached_iterator(), 64)
    else:
        rng = np.random.default_rng(5)
        source = (t._transfer.transfer(t._prepare(b, rng)) for b in
                  make_batches(t.dataset, 8, t.buckets, seed=5,
                               shuffle=True,
                               audio_samples=t._max_audio_samples()))
    out = {}
    for b in source:
        got = out.setdefault(b["mel"].shape[1], [])
        if len(got) < per_bucket:
            got.append(b)
    assert len(out) == len(t.buckets), sorted(out)
    return [b for k in sorted(out) for b in out[k]]


def _gan_state(t):
    out = {f"g.{k}": v for k, v in t.model.state_dict().items()}
    out.update({f"d.{k}": v for k, v in t.discriminator.state_dict().items()})
    if t.ema is not None:
        out.update({f"ema.{n}": e for n, e in zip(t.g_names, t.ema)})
    for net, opt in (("g", t.g_opt), ("d", t.d_opt)):
        sd = opt.state_dict()
        for m in ("mu", "nu"):
            out.update({f"{net}.{m}.{k}": v for k, v in sd[m].items()})
    return out


def _run_gan(tr, batches, nondet):
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    for b in batches:
        with disable_graphs():
            me = tr["eager"].train_step(dict(b))
        mg = tr["graph"].train_step(dict(b))
        assert set(me) == set(mg)
        for k in me:
            _held_graph(mg[k], me[k], nondet, k)
    se, sg = _gan_state(tr["eager"]), _gan_state(tr["graph"])
    for k, v in se.items():
        _held_graph(sg[k], v, nondet, k)


GAN_CASES = {
    "native_sn_f32": dict(discriminator_spectral_norm=True, bf16=False),
    "native_sn_bf16": dict(discriminator_spectral_norm=True, bf16=True),
    "native_f32": dict(disc_lowering="native", bf16=False),
    "native_bf16": dict(disc_lowering="native", bf16=True),
    "packed_f32": dict(disc_lowering="packed", bf16=False),
    "packed_bf16": dict(disc_lowering="packed", bf16=True),
}


@needs_cuda
@pytest.mark.parametrize("case", list(GAN_CASES))
def test_gan_step_graph_equals_eager(tmp_path, no_tf32, nondet_ops, case):
    """Four fused steps over two buckets (host batches), with EMA, both
    guards, the envelope loss, the warmup ramp over 2 updates and dropout
    0.1: losses, weights, EMA and Adam moments of the graph run against
    ``disable_graphs()`` eager."""
    tr = _gan_pair(tmp_path, ema_decay=0.5, adaptive_adv_dloss_floor=2.0,
                   adaptive_d_lr_floor=2.0, envelope_loss_weight=4.0,
                   adversarial_warmup_steps=2, **GAN_CASES[case])
    g = tr["graph"]
    assert g._graphs is not None and g.g_opt.capturable
    _run_gan(tr, _gan_batches(g, 2, cached=False), nondet_ops)
    assert g._graphs.stats() == {"graphs": 2, "replays": 2}
    assert g.d_updates == g.g_updates == 4 and g.d_opt.count == 4
    for t in tr.values():
        t.close()


@needs_cuda
@pytest.mark.parametrize("kw,graphs", [
    ({"device_data_cache": True, "ema_decay": 0.5}, 2),
    ({"alternate_gd": True}, 4),
    ({"gradient_accumulation_steps": 2, "adaptive_d_lr_floor": 2.0}, 4),
], ids=["device_cached", "alternate", "accumulate_k2"])
def test_gan_step_modes_graph_equal_eager(tmp_path, no_tf32, nondet_ops, kw,
                                          graphs):
    """The device-cached step (the window cut inside the graph), D and G
    alternating (a graph each), and accumulation over k = 2 (a graph per
    optimizer branch), four steps at each of two buckets, graph against
    eager."""
    tr = _gan_pair(tmp_path, **kw)
    g = tr["graph"]
    batches = _gan_batches(tr["eager"], 4,
                           kw.get("device_data_cache", False))
    _run_gan(tr, batches, nondet_ops)
    assert g._graphs.stats()["graphs"] == graphs
    for t in tr.values():
        t.close()


@needs_cuda
def test_gan_validation_graph_reads_new_weights(tmp_path, no_tf32,
                                                nondet_ops):
    """Validation's forward as a graph against eager at every point: before
    training, after two steps (other weights, other audio), after two more,
    and after the step-2 checkpoint is loaded back (the step-2 audio
    again, bitwise: the same graph on the same inputs)."""
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    t = Stage2Trainer(_gan_config(tmp_path, ema_decay=0.5, save_every=2,
                                  max_steps=2),
                      dataset=DummyDataset(**GRAPH_DS_KW, keep_audio=True),
                      device="cuda")
    host = _gan_batches(t, 1, cached=False)[-1]

    def val():
        got = t._val_fwd(host, t._eval_params())
        with disable_graphs():
            want = t._val_fwd(host, t._eval_params())
        for i, (a, b) in enumerate(zip(got, want)):
            _held_graph(a, b, nondet_ops, f"val output {i}")
        return got

    v0 = val()
    t.train()  # steps 1-2, the checkpoint at 2
    v2 = val()
    t.max_steps = 4
    t.train()
    v4 = val()
    assert not torch.equal(v0[3], v2[3]) and not torch.equal(v2[3], v4[3])
    state, _, step = t.ckpt.restore(2)
    t._load_state(state, state["generator_ema"])
    assert step == 2
    assert torch.equal(val()[3], v2[3])
    assert t._graphs.stats()["graphs"] >= 2
    t.close()


@needs_cuda
def test_gan_step_failed_capture_raises(tmp_path):
    """A host sync inside the step raises at capture on CUDA; nothing falls
    back to eager."""
    t = Stage2Trainer(_gan_config(tmp_path),
                      dataset=DummyDataset(**GRAPH_DS_KW, keep_audio=True),
                      device="cuda")
    real = t._d_update

    def syncing(grads, d_loss, applies):
        float(d_loss.item())
        return real(grads, d_loss, applies)

    t._d_update = syncing
    with pytest.raises(RuntimeError):
        t.train_step(_gan_batches(t, 1, cached=False)[0])
    assert len(t._graphs) == 0
    t.close()


@needs_cuda
def test_stage1_accumulation_and_eval_graphs_equal_eager(tmp_path, no_tf32,
                                                         deterministic):
    """Stage 1 at k = 2 (two graphs a bucket: accumulate, accumulate and
    apply), four micro-steps at each of two buckets, and its eval step after the
    steps and after a restore of the initial state, graph against
    eager: bitwise."""
    from m2tts_tpu_torch.utils.graphs import disable_graphs

    ds = DummyDataset(**GRAPH_DS_KW)
    tr = {}
    for mode in ("eager", "graph"):
        cfg = _train_config(tmp_path / mode, gradient_accumulation_steps=2)
        cfg.set("model.text_encoder.dropout", 0.1)
        cfg.set("data.buckets", GRAPH_TRAIN_BUCKETS)
        tr[mode] = Stage1Trainer(cfg, dataset=ds, device="cuda")
    tr["graph"].model.load_state_dict(tr["eager"].model.state_dict())
    init = tr["graph"]._host_state_copy()
    by_bucket = {}
    for b in make_batches(ds, 8, tr["eager"].buckets, seed=5):
        got = by_bucket.setdefault(b["mel"].shape[1], [])
        if len(got) < 4:
            got.append(b)
    assert len(by_bucket) == 2, sorted(by_bucket)
    batches = [b for k in sorted(by_bucket) for b in by_bucket[k]]
    for b in batches:
        with disable_graphs():
            le = tr["eager"]._guarded_step(tr["eager"]._put(b))
        lg = tr["graph"]._guarded_step(tr["graph"]._put(b))
        for t in tr.values():
            t.step += 1
        for k in le:
            assert torch.equal(lg[k], le[k]), k
    for k, v in tr["eager"].model.state_dict().items():
        assert torch.equal(tr["graph"].model.state_dict()[k], v), k
    g = tr["graph"]
    assert g.optimizer.count == 4 and g._graphs.stats()["graphs"] == 4

    def evals():
        out = []
        for b in batches[::4]:
            got = g._eval_step(g._put(b))
            with disable_graphs():
                want = g._eval_step(g._put(b))
            for k in want:
                assert torch.equal(got[k], want[k]), k
            out.append(got["total_loss"])
        return out

    trained = evals()
    g._restore(init, 0)
    restored = evals()
    assert all(not torch.equal(a, b) for a, b in zip(trained, restored))
    for t in tr.values():
        t.close()
