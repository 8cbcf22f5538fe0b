"""Dataset and bucketed fixed-shape batching (NumPy, on the host).

A copy of ``m2tts_tpu/data/dataset.py`` for the PyTorch port: every batch is
padded to one of a few (text, mel) bucket shapes, mel is channel-last
``[T, C]``, ``text_length`` is the non-SIL phoneme count, and the uniform
duration targets keep the reference's quirk (``uniform_durations``). The
same seed gives the same batches, bit for bit and in the same order, as the
JAX package.
"""

from __future__ import annotations

import logging
import pickle
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from m2tts_tpu_torch.frontend.audio import AudioProcessor
from m2tts_tpu_torch.frontend.text import SIL_ID, TextProcessor

logger = logging.getLogger(__name__)

Bucket = Tuple[int, int]  # (max_text_len, max_mel_frames)


def uniform_durations(n_ids: int, text_length: int,
                      mel_length: int) -> np.ndarray:
    """Uniform duration targets, reference quirk kept (reference
    src/data/dataset.py:182-196): ``mel_length / text_length`` assigned to
    the first ``text_length`` positions, zeros for the remaining
    (SIL-padding) ids; all zeros when ``text_length == 0``."""
    durations = np.zeros((n_ids,), np.float32)
    if text_length > 0:
        n = min(text_length, n_ids)
        durations[:n] = mel_length / text_length
    return durations


def select_bucket(text_len: int, mel_len: int,
                  buckets: Sequence[Bucket]) -> Bucket:
    """Smallest bucket that fits both lengths; the LAST bucket acts as a
    cap (longer samples are truncated into it by ``collate``)."""
    for bt, bm in buckets:
        if text_len <= bt and mel_len <= bm:
            return (bt, bm)
    return tuple(buckets[-1])


def collate(samples: List[Dict[str, Any]], bucket: Bucket,
            audio_samples: Optional[int] = None,
            n_valid: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad/truncate a list of samples into ONE fixed-shape batch.

    Output keys (all numpy, fixed shapes for the given bucket):
      phoneme_ids [B, bt] int32 (SIL-padded), text_lengths [B] int32,
      durations [B, bt] f32, mel [B, bm, C] f32, mel_lengths [B] int32,
      n_valid () int32 (the REAL sample count: positions >= n_valid are
      cycled duplicates from drop_last=False padding — metric consumers
      must exclude them), and audio [B, audio_samples] f32 when
      ``audio_samples`` is given and every sample carries a waveform.
    """
    bt, bm = bucket
    B = len(samples)
    C = int(np.asarray(samples[0]["mel"]).shape[1])
    phoneme_ids = np.full((B, bt), SIL_ID, np.int32)
    text_lengths = np.zeros((B,), np.int32)
    durations = np.zeros((B, bt), np.float32)
    mel = np.zeros((B, bm, C), np.float32)
    mel_lengths = np.zeros((B,), np.int32)
    has_audio = audio_samples is not None and all(
        "audio" in s for s in samples)
    audio = (np.zeros((B, int(audio_samples)), np.float32)
             if has_audio else None)
    for i, s in enumerate(samples):
        ids = np.asarray(s["phoneme_ids"], np.int32)[:bt]
        phoneme_ids[i, : len(ids)] = ids
        text_lengths[i] = min(int(s["text_length"]), len(ids))
        d = np.asarray(s["durations"], np.float32)[:bt]
        durations[i, : len(d)] = d
        m = np.asarray(s["mel"], np.float32)[:bm]
        mel[i, : m.shape[0]] = m
        mel_lengths[i] = min(int(s["mel_length"]), m.shape[0])
        if has_audio:
            a = np.asarray(s["audio"], np.float32)[: int(audio_samples)]
            audio[i, : len(a)] = a
    batch = {
        "phoneme_ids": phoneme_ids,
        "text_lengths": text_lengths,
        "durations": durations,
        "mel": mel,
        "mel_lengths": mel_lengths,
        # 0-d on purpose: device-transfer paths skip ndim==0 entries, so
        # the count never leaks into compiled-graph signatures
        "n_valid": np.int32(n_valid if n_valid is not None else B),
    }
    if has_audio:
        batch["audio"] = audio
    return batch


def make_batches(dataset, batch_size: int, buckets: Sequence[Bucket],
                 seed: int = 0, shuffle: bool = True,
                 audio_samples: Optional[int] = None,
                 drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of fixed-shape batches.

    Samples are routed to the smallest bucket that fits them; a bucket's
    batch is emitted as soon as it holds ``batch_size`` samples, so the
    epoch interleaves buckets in (shuffled) arrival order. With
    ``drop_last=False`` every leftover group is padded to ``batch_size``
    by cycling its own samples — shapes stay fixed, nothing is dropped
    (evaluation path; reference DataLoader drops remainders,
    src/data/dataset.py:283-308).
    """
    buckets = [tuple(b) for b in buckets]
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    pending: Dict[Bucket, List[Dict[str, Any]]] = {b: [] for b in buckets}
    for i in order:
        s = dataset[int(i)]
        b = select_bucket(len(s["phoneme_ids"]), int(s["mel_length"]), buckets)
        group = pending[b]
        group.append(s)
        if len(group) == batch_size:
            yield collate(group, b, audio_samples)
            pending[b] = []
    if not drop_last:
        for b, group in pending.items():
            if not group:
                continue
            k = len(group)
            while len(group) < batch_size:
                group.append(group[len(group) % k])
            yield collate(group, b, audio_samples, n_valid=k)


def data_iterator(dataset, batch_size: int, buckets: Sequence[Bucket],
                  seed: int = 0, audio_samples: Optional[int] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite epoch-reshuffling batch stream for the training loops."""
    if len(dataset) == 0:
        raise ValueError("data_iterator over an empty dataset")
    epoch = 0
    while True:
        n = 0
        for batch in make_batches(dataset, batch_size, buckets,
                                  seed=seed + epoch, shuffle=True,
                                  audio_samples=audio_samples):
            n += 1
            yield batch
        if n == 0:
            # dataset smaller than one batch: pad-repeat so training on a
            # tiny corpus still produces full fixed-shape batches
            yield from make_batches(dataset, batch_size, buckets,
                                    seed=seed + epoch, shuffle=True,
                                    audio_samples=audio_samples,
                                    drop_last=False)
        epoch += 1



class DataLoader:
    """Re-iterable epoch loader: each ``iter()`` is a fresh epoch of
    ``make_batches`` (shuffled from ``seed`` + the epoch's index).

    The JAX package's host-thread counterpart of the reference's torch
    DataLoader factory (reference src/data/dataset.py:283-308); device
    overlap comes from ``data/prefetch.py``, not worker processes."""

    def __init__(self, dataset, batch_size: int, buckets: Sequence[Bucket],
                 shuffle: bool = True, seed: int = 0,
                 audio_samples: Optional[int] = None, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = [tuple(b) for b in buckets]
        self.shuffle = shuffle
        self.seed = seed
        self.audio_samples = audio_samples
        self.drop_last = drop_last
        self._epoch = 0
        self._len: Optional[int] = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        seed = self.seed + (self._epoch if self.shuffle else 0)
        self._epoch += 1
        return make_batches(self.dataset, self.batch_size, self.buckets,
                            seed=seed, shuffle=self.shuffle,
                            audio_samples=self.audio_samples,
                            drop_last=self.drop_last)

    def __len__(self) -> int:
        """Batches an epoch: full batches of each bucket, plus one padded
        batch per non-empty remainder under ``drop_last=False`` (one pass
        over the samples' lengths, cached)."""
        if self._len is None:
            per_bucket: Dict[Bucket, int] = {}
            for i in range(len(self.dataset)):
                s = self.dataset[i]
                b = select_bucket(len(s["phoneme_ids"]),
                                  int(s["mel_length"]), self.buckets)
                per_bucket[b] = per_bucket.get(b, 0) + 1
            total = 0
            for count in per_bucket.values():
                full, rem = divmod(count, self.batch_size)
                total += full + (0 if (self.drop_last or rem == 0) else 1)
            self._len = total
        return self._len


def create_dataloader(dataset, batch_size: int = 2,
                      buckets: Optional[Sequence[Bucket]] = None,
                      shuffle: bool = True, seed: int = 0,
                      audio_samples: Optional[int] = None,
                      drop_last: bool = True) -> DataLoader:
    """A ``DataLoader`` with the default buckets (64, 256), (128, 512),
    (256, 1000) (reference src/data/dataset.py:283-308)."""
    if buckets is None:
        buckets = [(64, 256), (128, 512), (256, 1000)]
    return DataLoader(dataset, batch_size, buckets, shuffle=shuffle,
                      seed=seed, audio_samples=audio_samples,
                      drop_last=drop_last)

class TTSDataset:
    """LJSpeech-format or paired wav/txt corpus, preprocessed to numpy.

    Rebuild of the reference TTSDataset (src/data/dataset.py:19-230):
    same two ingest modes (``metadata.csv`` + ``wavs/`` LJSpeech layout,
    else ``*.wav`` with sibling ``*.txt``), same pickle preprocessing
    cache, same uniform-duration alignment, same truncation caps. New:
    ``keep_audio`` retains the resampled waveform (trimmed/padded to
    ``mel_length * hop``) for stage-2 GAN training.
    """

    def __init__(self, data_dir: Union[str, Path],
                 audio_processor: Optional[AudioProcessor] = None,
                 text_processor: Optional[TextProcessor] = None,
                 subset_size: Optional[int] = None,
                 max_text_length: int = 256, max_mel_length: int = 1000,
                 keep_audio: bool = False,
                 cache_dir: Optional[Union[str, Path]] = None):
        self.data_dir = Path(data_dir)
        self.audio_processor = audio_processor or AudioProcessor()
        self.text_processor = text_processor or TextProcessor()
        self.subset_size = subset_size
        self.max_text_length = int(max_text_length)
        self.max_mel_length = int(max_mel_length)
        self.keep_audio = bool(keep_audio)
        self.cache_dir = Path(cache_dir) if cache_dir else (
            self.data_dir / "cache")
        t0 = time.perf_counter()
        self.samples = self._load_samples()
        logger.info("TTSDataset: %d samples from %s in %.2f s",
                    len(self.samples), self.data_dir,
                    time.perf_counter() - t0)

    # -- ingest ---------------------------------------------------------------
    def _cache_file(self) -> Path:
        # the tag must cover EVERY parameter that changes the cached mels
        # (or the audio policy) — a collision silently serves stale
        # features computed with different STFT settings
        ap = self.audio_processor
        fmax = "none" if ap.fmax is None else f"{float(ap.fmax):g}"
        tag = (f"{ap.n_mels}m_{ap.n_fft}fft_{ap.hop_length}h_"
               f"{ap.win_length}w_{ap.sample_rate}sr_"
               f"{float(ap.fmin):g}lo_{fmax}hi_"
               f"{self.max_text_length}t_{self.max_mel_length}f"
               + ("_audio" if self.keep_audio else "")
               # subset runs cache a TRUNCATED corpus — without this tag a
               # later full-corpus run would silently load the subset as
               # the whole dataset
               + (f"_{self.subset_size}ss" if self.subset_size else ""))
        return self.cache_dir / f"processed_{tag}.pkl"

    def _load_samples(self) -> List[Dict[str, Any]]:
        cache = self._cache_file()
        if cache.exists():
            logger.info("Loading cached samples from %s", cache)
            with open(cache, "rb") as f:
                samples = pickle.load(f)
            return samples[: self.subset_size] if self.subset_size else samples

        if (self.data_dir / "metadata.csv").exists():
            samples = self._load_ljspeech()
        else:
            samples = self._load_paired_files()
        if self.subset_size:
            samples = samples[: self.subset_size]

        self.cache_dir.mkdir(parents=True, exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(samples, f)
        return samples

    def _load_ljspeech(self) -> List[Dict[str, Any]]:
        """``id|text|normalized_text`` lines; the normalized field wins
        when present (reference src/data/dataset.py:107-135)."""
        wavs = self.data_dir / "wavs"
        samples = []
        text = (self.data_dir / "metadata.csv").read_text(encoding="utf-8")
        for line in text.splitlines():
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            utt_text = parts[2] if len(parts) >= 3 and parts[2] else parts[1]
            wav = wavs / f"{parts[0]}.wav"
            if not wav.exists():
                continue
            try:
                s = self._process_sample(wav, utt_text)
            except Exception as e:  # skip unreadable utterances, keep going
                logger.warning("Failed to process %s: %s", wav, e)
                continue
            if s is not None:
                samples.append(s)
                if self.subset_size and len(samples) >= self.subset_size:
                    break  # don't mel-process the 12.9k utterances a
                    # subset smoke run is about to throw away
        return samples

    def _load_paired_files(self) -> List[Dict[str, Any]]:
        """``x.wav`` + ``x.txt`` pairs anywhere under the data dir
        (reference src/data/dataset.py:137-166). Deviation: the reference
        also globs .mp3/.flac because librosa decodes them; this repo's
        frontend is librosa-free (stdlib WAV reader), so compressed
        formats must be converted to WAV first."""
        samples = []
        for wav in sorted(self.data_dir.glob("**/*.wav")):
            txt = wav.with_suffix(".txt")
            if not txt.exists():
                continue
            try:
                s = self._process_sample(
                    wav, txt.read_text(encoding="utf-8").strip())
            except Exception as e:
                logger.warning("Failed to process %s: %s", wav, e)
                continue
            if s is not None:
                samples.append(s)
                if self.subset_size and len(samples) >= self.subset_size:
                    break
        return samples

    def _process_sample(self, wav: Path, text: str
                        ) -> Optional[Dict[str, Any]]:
        audio, mel_cf = self.audio_processor.process_file(wav)
        mel = mel_cf.T[: self.max_mel_length]  # [T, C] channel-last
        mel_length = int(mel.shape[0])
        info = self.text_processor.process(text)
        ids = np.asarray(info["phoneme_ids"],
                         np.int32)[: self.max_text_length]
        text_length = min(int(info["length"]), len(ids))
        if mel_length == 0 or len(ids) == 0:
            return None
        sample: Dict[str, Any] = {
            "text": text,
            "phoneme_ids": ids,
            "text_length": text_length,
            "durations": uniform_durations(len(ids), text_length, mel_length),
            "mel": np.asarray(mel, np.float32),
            "mel_length": mel_length,
        }
        if self.keep_audio:
            hop = self.audio_processor.hop_length
            want = mel_length * hop
            a = np.asarray(audio, np.float32)[:want]
            if len(a) < want:
                a = np.pad(a, (0, want - len(a)))
            sample["audio"] = a
        return sample

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.samples[idx]


class DummyDataset:
    """Deterministic synthetic dataset for data-free runs and tests.

    Reference DummyDataset (src/data/dataset.py:303-353) regenerated each
    ``__getitem__`` with torch's global RNG (non-reproducible); here every
    index is a pure function of ``(seed, idx)``. Extended with a synthetic
    waveform (``mel_length * hop`` samples) so stage-2 GAN training runs
    data-free too.
    """

    def __init__(self, size: int = 100, mel_dim: int = 64,
                 max_text_length: int = 50, max_mel_length: int = 200,
                 seed: int = 0, vocab_size: int = 64,
                 keep_audio: bool = True, hop_length: int = 256,
                 cache: bool = True):
        self.size = int(size)
        self.mel_dim = int(mel_dim)
        self.max_text_length = int(max_text_length)
        self.max_mel_length = int(max_mel_length)
        self.seed = int(seed)
        self.vocab_size = int(vocab_size)
        self.keep_audio = bool(keep_audio)
        self.hop_length = int(hop_length)
        # Regenerating the mel + waveform arrays on every access costs
        # ~100x a dict lookup and dominated data-free train steps;
        # samples are pure functions of (seed, idx), so memoize.
        self._cache: Optional[Dict[int, Dict[str, Any]]] = (
            {} if cache else None)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng([self.seed, int(idx)])
        text_low = min(10, max(self.max_text_length - 1, 1))
        mel_low = min(50, max(self.max_mel_length - 1, 1))
        text_len = int(rng.integers(text_low, self.max_text_length))
        mel_len = int(rng.integers(mel_low, self.max_mel_length))
        ids = rng.integers(1, self.vocab_size, size=text_len).astype(np.int32)
        durations = rng.random(text_len).astype(np.float64)
        durations = (durations / durations.sum() * mel_len).astype(np.float32)
        mel = rng.uniform(-1.0, 1.0,
                          size=(mel_len, self.mel_dim)).astype(np.float32)
        sample: Dict[str, Any] = {
            "text": f"dummy_text_{idx}",
            "phoneme_ids": ids,
            "text_length": text_len,
            "durations": durations,
            "mel": mel,
            "mel_length": mel_len,
        }
        if self.keep_audio:
            sample["audio"] = (0.1 * rng.standard_normal(
                mel_len * self.hop_length)).astype(np.float32)
        if self._cache is not None:
            self._cache[idx] = sample
        return sample
