"""Streaming chunked vocoder: low-latency single-stream synthesis.

Counterpart of ``m2tts_tpu/serving/streaming.py``. The vocoder is fully
convolutional with a receptive field of under ±2.5 mel frames, so vocoding
fixed ``chunk_frames`` windows with ``halo_frames`` of context on each side
reproduces the whole-utterance output:

- windows are contiguous slices of the true mel, shifted inward at the
  utterance edges so the window boundary is the array boundary there and
  the convs' own SAME padding gives the whole graph's edge values (zero
  halo frames would not: conv biases make them nonzero activations);
- every window has the same shape, so one vocoder call serves every chunk
  and only the last chunk's centre is shorter;
- the chunks run through the same vocoder dispatch as the batch path
  (``pipeline.make_vocoder_fn``): on CUDA the hand-written kernels
  ``vocoder_tc.cu`` (bf16) and ``vocoder_tc32.cu`` (f32).

An utterance no longer than one window takes the short path: the whole mel
in one call, in f32 whatever the stream's compute dtype, as the JAX package
does. On CUDA that call is the f32 kernel on ``[1, T, C]`` (the CUDA
kernel takes any length, so the TPU package's widening of the halo to
16-frame tiles is not needed either).

On CUDA the chunk call is one CUDA graph per batch of ``[B, W, C]``
windows, the acoustic pass one per (batch, text bucket), and the fused
acoustic pass + first chunk one per text bucket (``utils/graphs.py``, the
counterparts of the JAX package's jitted ``run_chunk``, ``acoustic`` and
``acoustic_first``); a window is copied into the chunk graph's input and
the duration scale into the acoustic graphs'. The short path is one graph
per length in the chunk graphs' runner, as JAX compiles and caches it once
per length; it is not padded to the window, whose zero frames would not be
the utterance's true boundary.

Every generator here runs under ``torch.inference_mode`` in the thread that
consumes it.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from m2tts_tpu_torch.frontend.text import TextProcessor
from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.ops.length_regulator import regulate_lengths
from m2tts_tpu_torch.ops.vocoder_mm import DTYPES
from m2tts_tpu_torch.serving.pipeline import (_finish_fetch, _start_fetch,
                                              make_vocoder_fn,
                                              resolve_backend,
                                              split_text_to_budget)
from m2tts_tpu_torch.utils.device import resolve_device
from m2tts_tpu_torch.utils.graphs import GraphRunner

# Receptive field of the vocoder in mel frames: input conv ±1, first tconv
# ±1, then under ±0.5 for every supported rate config; 4 is conservative.
DEFAULT_HALO_FRAMES = 4


def _scale(duration_scale) -> torch.Tensor:
    """The duration scale as a 0-d f32 tensor (a graph input)."""
    return torch.tensor(float(duration_scale), dtype=torch.float32)


class StreamingVocoder:
    """Chunked mel → waveform over the batch path's vocoder dispatch."""

    def __init__(self, model: M2TTS, chunk_frames: int = 64,
                 halo_frames: int = DEFAULT_HALO_FRAMES,
                 vocoder_backend: str = "auto", compute_dtype: str = "f32",
                 device="cuda"):
        """``vocoder_backend``: 'torch' (the ``Vocoder`` module), 'mm' (the
        plain packed-matmul version), 'cuda' (the fused kernels) or 'auto'
        ('cuda' on a CUDA device, 'torch' on the CPU).

        ``compute_dtype``: 'f32' (the default, where streamed equals whole
        most tightly), 'bf16', or 'auto' (bf16 on CUDA, f32 on the CPU).
        ``device`` defaults to CUDA and raises without it; the model is
        moved there."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        vocoder_backend, compute_dtype = resolve_backend(
            vocoder_backend, compute_dtype, self.device)
        self.vocoder_backend, self.compute_dtype = vocoder_backend, compute_dtype
        self.chunk_frames = int(chunk_frames)
        self.halo = int(halo_frames)
        self.upsample = model.total_upsample
        self._window = self.halo + self.chunk_frames + self.halo

        # _chunk_fn: f32 mel [B, window, C] → f32 audio [B, window·U] in
        # the stream's dtype (``_run_chunk`` runs it as a graph); _full: the
        # short path, always f32
        self._chunk_fn: Callable[[torch.Tensor], torch.Tensor]
        self._full: Callable[[torch.Tensor], torch.Tensor]
        if vocoder_backend == "torch":
            dt = DTYPES[compute_dtype]
            module = (model.vocoder if dt == torch.float32
                      else copy.deepcopy(model.vocoder).to(dt))
            self._chunk_fn = lambda mel: module(mel.to(dt))[..., 0].float()
            self._full = lambda mel: model.vocoder(mel)[..., 0]
        else:
            self._chunk_fn = make_vocoder_fn(model, vocoder_backend,
                                             compute_dtype)
            self._full = (self._chunk_fn if compute_dtype == "f32" else
                          make_vocoder_fn(model, vocoder_backend, "f32"))
        self.graphs = GraphRunner(self.device)

    def _run_chunk(self, mel: torch.Tensor) -> torch.Tensor:
        """The chunk call on windows [B, W, C]: one graph per B."""
        return self.graphs(("chunk",), self._chunk_fn, mel)

    def _window_start(self, ci: int, total: int) -> int:
        """Start frame of chunk ``ci``'s window in a ``total``-frame mel."""
        return min(max(ci * self.chunk_frames - self.halo, 0),
                   total - self._window)

    def _short(self, mel: torch.Tensor) -> np.ndarray:
        """The whole mel [T, C] (T ≤ window) in one f32 call: one graph per
        T."""
        if mel.shape[0] == 0:
            return np.zeros(0, np.float32)
        return self.graphs(("short",), self._full,
                           mel[None])[0].cpu().numpy()

    @torch.inference_mode()
    def stream(self, mel, total_frames: Optional[int] = None
               ) -> Iterator[np.ndarray]:
        """Yield waveform chunks for ``mel`` [T, C] (one utterance; a numpy
        array or a tensor on any device), cut to ``total_frames``."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        T = int(total_frames) if total_frames is not None else mel.shape[0]
        mel = mel[:T]
        U, W, cf = self.upsample, self._window, self.chunk_frames
        if T <= W:
            yield self._short(mel)
            return
        for ci in range(-(-T // cf)):
            s, e = ci * cf, min((ci + 1) * cf, T)
            w = self._window_start(ci, T)
            audio = self._run_chunk(mel[w: w + W][None])
            off = (s - w) * U
            yield audio[0, off: off + (e - s) * U].cpu().numpy()

    @torch.inference_mode()
    def stream_device(self, mel: torch.Tensor, total_frames: int,
                      start_chunk: int = 0) -> Iterator[np.ndarray]:
        """``stream()`` for a padded mel [1, Tmax, C] already on the device,
        from chunk ``start_chunk`` on. Windows are slices of it (no
        per-chunk host→device traffic), and each chunk's device→host copy
        is enqueued behind its vocoder call: chunk i+1 is enqueued before
        the host waits for chunk i, so the device vocodes i+1 while the
        host hands out i. Yields the values ``stream()`` yields."""
        T = int(total_frames)
        U, W, cf = self.upsample, self._window, self.chunk_frames
        if T <= W:
            yield from self.stream(mel[0], T)
            return
        pending = None
        for ci in range(start_chunk, -(-T // cf)):
            s, e = ci * cf, min((ci + 1) * cf, T)
            w = self._window_start(ci, T)
            out = self._run_chunk(mel[:, w: w + W])
            off = (s - w) * U
            launched = _start_fetch(out[0, off: off + (e - s) * U])
            if pending is not None:
                yield _finish_fetch(pending)
            pending = launched
        if pending is not None:
            yield _finish_fetch(pending)

    def synthesize(self, mel, total_frames: Optional[int] = None
                   ) -> np.ndarray:
        """All streamed chunks, concatenated."""
        return np.concatenate(list(self.stream(mel, total_frames)))


class StreamingSynthesizer:
    """Text → first audio chunk fast: one acoustic pass, then chunked
    vocoding. Shares the model (and its device) with the batch
    ``Synthesizer``."""

    def __init__(self, model: M2TTS, chunk_frames: int = 64,
                 max_frames: int = 1000, text_bucket: int = 128,
                 halo_frames: int = DEFAULT_HALO_FRAMES,
                 vocoder_backend: str = "auto", compute_dtype: str = "f32",
                 sample_rate: int = 22050, device="cuda"):
        self.vocoder = StreamingVocoder(model, chunk_frames, halo_frames,
                                        vocoder_backend, compute_dtype,
                                        device)
        self.device = self.vocoder.device
        self.model = self.vocoder.model
        self.max_frames = int(max_frames)
        self.text_bucket = int(text_bucket)
        self.sample_rate = sample_rate  # sizes the long-form join gaps
        self.text_processor = TextProcessor()
        dt = DTYPES[self.vocoder.compute_dtype]
        self._acoustic_model = (self.model if dt == torch.float32
                                else copy.deepcopy(self.model).to(dt))
        # the first chunk's window is mel[:, :W] whenever the utterance is
        # longer than a window, so it is enqueued right behind the acoustic
        # pass (see _stream_one); needs a mel at least one window long
        self._fuse_first = self.max_frames >= self.vocoder._window
        # the acoustic graphs; the chunk graphs are the vocoder's
        self.graphs = GraphRunner(self.device)

    def _acoustic(self, ids: torch.Tensor, lengths: torch.Tensor,
                  duration_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids [B, S], lengths [B] → (f32 mel [B, max_frames, C], total
        frames [B] int32, uncapped) on the device, in the stream's compute
        dtype: one graph per (B, S)."""
        return self.graphs(("acoustic",), self._acoustic_fn, ids, lengths,
                           _scale(duration_scale))

    def _acoustic_fn(self, ids: torch.Tensor, lengths: torch.Tensor,
                     scale: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The acoustic pass; ``scale`` is a 0-d f32 tensor. The durations
        come from the predictor in the compute dtype and are scaled in f32,
        as the JAX streaming pass does (the batch path's frame probe is
        f32 throughout)."""
        m = self._acoustic_model
        enc, mask = m.text_encoder(ids, lengths)
        durations = m.duration_predictor(enc) * mask.to(enc.dtype)
        regulated, frame_mask, total = regulate_lengths(
            enc, durations.float() * scale, self.max_frames)
        mel = m.decoder(regulated, frame_mask if m.mask_decoder else None)
        return mel.float(), total

    def _acoustic_first_fn(self, ids: torch.Tensor, lengths: torch.Tensor,
                           scale: torch.Tensor):
        """The acoustic pass and chunk 0 in one graph: (mel, total, chunk
        0's centre followed by the frame count, in one f32 vector)."""
        sv = self.vocoder
        mel, total = self._acoustic_fn(ids, lengths, scale)
        audio0 = sv._chunk_fn(mel[:, :sv._window].contiguous())
        head = audio0[0, :sv.chunk_frames * sv.upsample]
        return mel, total, torch.cat([head, total.to(head.dtype)])

    def split_long(self, text: str) -> List[str]:
        """Texts over the phoneme budget split by sentence (the splitter of
        ``Synthesizer.synthesize_long``); shorter texts pass whole."""
        budget = self.text_bucket - 2  # room for the SIL wrap
        if len(self.text_processor.text_to_phonemes(text)) <= budget:
            return [text]
        return split_text_to_budget(text, self.text_processor, budget)

    def gap(self, gap_ms: float) -> np.ndarray:
        """Silence between long-form chunks."""
        return np.zeros(int(self.sample_rate * gap_ms / 1000.0), np.float32)

    def stream(self, text: str, duration_scale: float = 1.0,
               gap_ms: float = 120.0) -> Iterator[np.ndarray]:
        """Yield waveform chunks for ``text`` of any length: long texts
        stream sentence by sentence with ``gap_ms`` of silence between, so
        the first chunk waits on one sentence only."""
        for i, chunk in enumerate(self.split_long(text)):
            if i:
                yield self.gap(gap_ms)
            yield from self._stream_one(chunk, duration_scale)

    @torch.inference_mode()
    def _stream_one(self, text: str, duration_scale: float
                    ) -> Iterator[np.ndarray]:
        enc = self.text_processor.batch([text], self.text_bucket)
        ids = torch.from_numpy(enc["phoneme_ids"])
        lengths = torch.from_numpy(enc["lengths"])
        sv = self.vocoder
        W, n0 = sv._window, sv.chunk_frames * sv.upsample
        if not self._fuse_first:
            mel, total = self._acoustic(ids, lengths, duration_scale)
            frames = min(int(total[0]), self.max_frames)
            yield from sv.stream(mel[0], frames)
            return
        # acoustic pass and chunk 0 in one call with no host sync between
        # them, then one device→host copy carries chunk 0's centre and the
        # frame count
        mel, _, head = self.graphs(("acoustic_first",),
                                   self._acoustic_first_fn, ids, lengths,
                                   _scale(duration_scale))
        host = head.cpu().numpy()
        frames = min(int(host[n0]), self.max_frames)
        if frames <= W:
            # chunk 0's fixed window would read past the utterance's end
            yield from sv.stream(mel[0], frames)
            return
        yield host[:n0]
        yield from sv.stream_device(mel, frames, start_chunk=1)
