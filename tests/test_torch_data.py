"""Data pipeline of the PyTorch port (``data/dataset.py``, ``data/prefetch.py``,
``data/device_cache.py``, ``frontend/audio.py``) against the JAX package's:
the same seed gives bit-equal samples and batches in the same order; a
corpus written here loads to the same mels (within 1e-5); the device
cache's order, its byte budget, the prefetcher's order, errors and close,
and the host bf16 cast of ``transfer_dtype`` (bit-equal to ml_dtypes').
Every thread is a daemon with a timed join."""

import shutil
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from m2tts_tpu.data import dataset as jds
from m2tts_tpu.data import device_cache as jcache
from m2tts_tpu.frontend import audio as jaudio
from m2tts_tpu_torch.data import dataset as tds
from m2tts_tpu_torch.data import device_cache as tcache
from m2tts_tpu_torch.data.prefetch import BatchTransfer, DevicePrefetcher
from m2tts_tpu_torch.frontend import audio as taudio

torch.set_num_threads(2)

BUCKETS = [(20, 80), (40, 150)]


def _batches_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_helpers_match_jax():
    for args in [(10, 4, 20), (5, 0, 20), (3, 7, 11)]:
        np.testing.assert_array_equal(tds.uniform_durations(*args),
                                      jds.uniform_durations(*args))
    buckets = [(64, 256), (128, 512), (256, 1000)]
    for tl, ml in [(10, 100), (10, 300), (200, 100), (500, 2000)]:
        assert tds.select_bucket(tl, ml, buckets) == \
            jds.select_bucket(tl, ml, buckets)


@pytest.mark.parametrize("keep_audio", [True, False])
def test_dummy_dataset_bit_equal(keep_audio):
    kw = dict(size=6, mel_dim=8, max_text_length=40, max_mel_length=150,
              seed=3, keep_audio=keep_audio, hop_length=64)
    t, j = tds.DummyDataset(**kw), jds.DummyDataset(**kw)
    assert len(t) == len(j) == 6
    for i in range(6):
        a, b = t[i], j[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


@pytest.mark.parametrize("drop_last", [True, False])
def test_make_batches_bit_equal_in_order(drop_last):
    kw = dict(size=37, mel_dim=8, max_text_length=40, max_mel_length=150,
              seed=0, hop_length=64)
    t = list(tds.make_batches(tds.DummyDataset(**kw), 4, BUCKETS, seed=5,
                              drop_last=drop_last, audio_samples=256))
    j = list(jds.make_batches(jds.DummyDataset(**kw), 4, BUCKETS, seed=5,
                              drop_last=drop_last, audio_samples=256))
    assert len(t) == len(j) > 4
    for a, b in zip(t, j):
        _batches_equal(a, b)
    if not drop_last:  # the padded leftovers count their real samples
        assert any(int(a["n_valid"]) < 4 for a in t)
        assert all(a["n_valid"].ndim == 0 for a in t)


def test_data_iterator_bit_equal_over_epochs():
    kw = dict(size=10, mel_dim=8, max_text_length=40, max_mel_length=150,
              seed=1)
    t = tds.data_iterator(tds.DummyDataset(**kw), 3, BUCKETS, seed=2)
    j = jds.data_iterator(jds.DummyDataset(**kw), 3, BUCKETS, seed=2)
    for _ in range(12):  # several epochs
        _batches_equal(next(t), next(j))
    # a dataset smaller than one batch is pad-repeated, as in JAX
    small = dict(kw, size=2)
    t = tds.data_iterator(tds.DummyDataset(**small), 4, BUCKETS, seed=0)
    j = jds.data_iterator(jds.DummyDataset(**small), 4, BUCKETS, seed=0)
    for _ in range(3):
        _batches_equal(next(t), next(j))
    with pytest.raises(ValueError):
        next(tds.data_iterator(tds.DummyDataset(size=0), 2, BUCKETS))


def _write_corpus(root, layout):
    sr = 22050
    rng = np.random.default_rng(0)
    texts = ["Hello world.", "The quick brown fox.", "A test of speech."]
    lines = []
    for i, text in enumerate(texts):
        n = sr // 4 + 777 * i
        audio = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * np.arange(n) / sr)
                 + 0.01 * rng.standard_normal(n)).astype(np.float32)
        if layout == "ljspeech":
            jaudio.save_wav(audio, root / "wavs" / f"utt{i}.wav", sr)
            lines.append(f"utt{i}|{text}|{text}")
        else:
            jaudio.save_wav(audio, root / f"utt{i}.wav", sr)
            (root / f"utt{i}.txt").write_text(text)
    if lines:
        (root / "metadata.csv").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("layout", ["ljspeech", "paired"])
def test_tts_dataset_mels_match_jax(tmp_path, layout):
    _write_corpus(tmp_path, layout)
    kw = dict(n_mels=8, n_fft=512, hop_length=128, win_length=512)
    t = tds.TTSDataset(tmp_path, taudio.AudioProcessor(**kw),
                       keep_audio=True, cache_dir=tmp_path / "tcache")
    j = jds.TTSDataset(tmp_path, jaudio.AudioProcessor(**kw),
                       keep_audio=True, cache_dir=tmp_path / "jcache")
    assert len(t) == len(j) == 3
    for a, b in zip(t.samples, j.samples):
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["phoneme_ids"], b["phoneme_ids"])
        assert (a["text_length"], a["mel_length"]) == \
            (b["text_length"], b["mel_length"])
        np.testing.assert_array_equal(a["durations"], b["durations"])
        np.testing.assert_allclose(a["mel"], b["mel"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(a["audio"], b["audio"])
    # the pickle cache serves the same samples on a second load
    again = tds.TTSDataset(tmp_path, taudio.AudioProcessor(**kw),
                           keep_audio=True, cache_dir=tmp_path / "tcache")
    np.testing.assert_array_equal(again[0]["mel"], t[0]["mel"])


def test_audio_frontend_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    audio = rng.uniform(-0.5, 0.5, 5000).astype(np.float32)
    np.testing.assert_allclose(taudio.stft(audio, 512, 128),
                               jaudio.stft(audio, 512, 128), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(taudio.mel_filterbank(22050, 512, 8),
                                  jaudio.mel_filterbank(22050, 512, 8))
    taudio.save_wav(audio, tmp_path / "t.wav")
    jaudio.save_wav(audio, tmp_path / "j.wav")
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    a, sr = taudio.load_wav(tmp_path / "t.wav")
    b, _ = jaudio.load_wav(tmp_path / "t.wav")
    assert sr == 22050
    np.testing.assert_array_equal(a, b)
    ap = taudio.AudioProcessor(n_mels=8, n_fft=512, hop_length=128,
                               win_length=512)
    np.testing.assert_allclose(
        ap.compute_mel(audio),
        jaudio.AudioProcessor(n_mels=8, n_fft=512, hop_length=128,
                              win_length=512,
                              use_native=False).compute_mel(audio),
        atol=1e-6, rtol=0)
    # use_native=True takes the C++ frontend, which 'auto' took above; it
    # raises only where the frontend cannot be built (no g++; the forced
    # build failure is in tests/test_torch_native.py)
    if shutil.which("g++") is None:
        with pytest.raises(RuntimeError, match="native"):
            taudio.AudioProcessor(use_native=True)
    else:
        native = taudio.AudioProcessor(n_mels=8, n_fft=512, hop_length=128,
                                       win_length=512, use_native=True)
        assert native._native is not None and ap._native is not None
        np.testing.assert_array_equal(native.compute_mel(audio),
                                      ap.compute_mel(audio))


def test_epoch_shuffled_same_order():
    staged = [{"i": np.int32(i)} for i in range(7)]
    t = tcache.epoch_shuffled(staged, 17)
    j = jcache.epoch_shuffled(staged, 17)
    assert [int(next(t)["i"]) for _ in range(30)] == \
        [int(next(j)["i"]) for _ in range(30)]


def test_stage_on_device_budget():
    ds = tds.DummyDataset(size=12, mel_dim=8, max_text_length=40,
                          max_mel_length=150, seed=0, keep_audio=False)
    transfer = BatchTransfer("cpu", torch.bfloat16)
    host = list(tds.make_batches(ds, 4, BUCKETS, seed=0, drop_last=False))
    staged = tcache.stage_on_device(iter(host), transfer.transfer, 1e9)
    assert len(staged) == len(host)
    # the budget counts the device tensors' bytes: bf16 mel counts half
    want = sum(sum(v.nbytes for v in b.values() if v.ndim)
               - b["mel"].nbytes // 2 for b in host)
    got = sum(t.nbytes for b in staged for t in b.values())
    assert got == want
    assert all("n_valid" not in b and b["mel"].dtype == torch.bfloat16
               for b in staged)
    assert tcache.stage_on_device(iter(host), transfer.transfer,
                                  want - 1) is None
    assert tcache.stage_on_device(iter([]), transfer.transfer, 1e9) is None


def test_transfer_dtype_rounds_like_ml_dtypes():
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((3, 50, 8)) * 10).astype(np.float32)
    mel.flat[:6] = [0.0, -0.0, 1e-40, 3.4e38, 1.00390625, 1.01171875]
    batch = {"mel": mel, "durations": mel[..., 0].copy(),
             "n_valid": np.int32(3)}
    out = BatchTransfer("cpu", torch.bfloat16).transfer(batch)
    assert set(out) == {"mel", "durations"}
    assert out["mel"].dtype == torch.bfloat16
    assert out["durations"].dtype == torch.float32  # only mel and audio
    ref = mel.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = out["mel"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, ref)


def _thread_count():
    return sum(t.name == "device-prefetcher" for t in threading.enumerate())


def test_prefetcher_order_and_ready_fn():
    seen = []
    pf = DevicePrefetcher(iter(range(20)), lambda x: x * 2, depth=3,
                          ready_fn=lambda x: seen.append(x) or x + 1)
    assert list(pf) == [2 * i + 1 for i in range(20)]
    assert seen == [2 * i for i in range(20)]
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._thread.daemon


def test_prefetcher_error_at_next():
    def source():
        yield 1
        raise ValueError("bad batch")

    pf = DevicePrefetcher(source(), lambda x: x)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_on_infinite_source():
    def forever():
        i = 0
        while True:
            yield i
            i += 1

    before = _thread_count()
    pf = DevicePrefetcher(forever(), lambda x: x, depth=2)
    assert [next(pf) for _ in range(5)] == list(range(5))
    time.sleep(0.05)  # let the worker block on the full queue
    pf.close()
    assert not pf._thread.is_alive()
    assert _thread_count() == before
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_with_transfer_gives_host_batches():
    ds = tds.DummyDataset(size=16, mel_dim=8, max_text_length=40,
                          max_mel_length=150, seed=0)
    host = list(tds.make_batches(ds, 4, BUCKETS, seed=1, audio_samples=128))
    transfer = BatchTransfer("cpu")
    pf = DevicePrefetcher(iter(host), transfer.put, 2,
                          ready_fn=transfer.ready)
    try:
        for h, d in zip(host, pf):
            for k, v in d.items():
                np.testing.assert_array_equal(v.numpy(), h[k])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
