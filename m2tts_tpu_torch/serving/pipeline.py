"""Batched synthesis: text → fixed-shape buckets → the model on the device.

Counterpart of ``m2tts_tpu/serving/pipeline.py``. Each request is padded to
a (batch, text, frames) bucket from a small set:

1. encode texts on the host to the smallest text bucket,
2. run the duration probe (encoder + duration predictor, always f32) to
   learn each utterance's frame count,
3. pick the frame bucket and run the synthesis there,
4. quantise to int16 PCM (or G.711 μ-law) on the device and trim on the
   host to ``total_frames × upsample``.

PyTorch runs eagerly, so a bucket is a set of shapes, not a compiled
graph; ``warmup`` runs each reachable shape once.
"""

from __future__ import annotations

import copy
import logging
import re
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from m2tts_tpu_torch.frontend.text import TextProcessor
from m2tts_tpu_torch.models.tts_model import M2TTS, build_model, init_params
from m2tts_tpu_torch.ops.audio_codec import mulaw_decode_np, mulaw_encode_pcm16
from m2tts_tpu_torch.ops.vocoder_mm import (DTYPES, pack_vocoder_weights,
                                            vocoder_mm_forward)
from m2tts_tpu_torch.utils.checkpoint import load_for_inference
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_TEXT_BUCKETS = (32, 64, 128, 256)
DEFAULT_FRAME_BUCKETS = (128, 256, 512, 1024)
DEFAULT_BATCH_BUCKETS = (1, 4, 8, 16, 32)

VOCODER_BACKENDS = ("torch", "mm", "cuda", "auto")


def _bucket_for(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def encode_packed_batch(text_processor, texts: List[str],
                        batch_buckets: Sequence[int],
                        text_buckets: Sequence[int]) -> np.ndarray:
    """Texts → packed [B, T+1] int32: SIL-padded phoneme-id rows with the
    lengths in the last column. Pad rows are all-SIL with length 0."""
    n = len(texts)
    batch_n = _bucket_for(n, batch_buckets)
    if n > batch_n:
        raise ValueError(f"{n} texts exceed the largest batch bucket "
                         f"{max(batch_buckets)}; split the request")
    max_phonemes = max(len(text_processor.text_to_phonemes(t))
                       for t in texts)
    t_bucket = _bucket_for(max_phonemes, text_buckets)
    enc = text_processor.batch(texts, t_bucket)
    sil = text_processor.phonemes_to_ids(["SIL"])[0]
    packed = np.full((batch_n, t_bucket + 1), sil, np.int32)
    packed[:n, :-1] = enc["phoneme_ids"]
    packed[:, -1] = 0
    packed[:n, -1] = enc["lengths"]
    return packed


def split_text_to_budget(text: str, text_processor, budget: int) -> List[str]:
    """Split ``text`` into chunks of at most ``budget`` phonemes: sentence
    boundaries ([.!?;:]) first with a greedy merge up to the budget; an
    over-budget sentence falls back to comma, then word splits."""
    n_phon = lambda t: len(text_processor.text_to_phonemes(t))  # noqa: E731

    def split_units(t: str, pattern: str) -> List[str]:
        parts = re.split(pattern, t)
        units, cur = [], ""
        for i in range(0, len(parts), 2):
            seg = parts[i] + (parts[i + 1] if i + 1 < len(parts) else "")
            if not seg.strip():
                continue
            cand = (cur + " " + seg).strip() if cur else seg.strip()
            if cur and n_phon(cand) > budget:
                units.append(cur)
                cur = seg.strip()
            else:
                cur = cand
        if cur:
            units.append(cur)
        return units

    out: List[str] = []
    for sent_chunk in split_units(text, r"([.!?;:]+\s*)"):
        if n_phon(sent_chunk) <= budget:
            out.append(sent_chunk)
            continue
        for comma_chunk in split_units(sent_chunk, r"(,\s*)"):
            if n_phon(comma_chunk) <= budget:
                out.append(comma_chunk)
                continue
            words, cur = comma_chunk.split(), ""
            for w in words:
                cand = (cur + " " + w).strip()
                if cur and n_phon(cand) > budget:
                    out.append(cur)
                    cur = w
                else:
                    cur = cand
            if cur:
                out.append(cur)
    return out or [text]


def resolve_backend(vocoder_backend: str, compute_dtype: str,
                    device: torch.device) -> Tuple[str, str]:
    """(vocoder backend, compute dtype) with 'auto' resolved for ``device``:
    'cuda' and bf16 on a CUDA device, 'torch' and f32 on the CPU. Raises
    ``ValueError`` for an unknown name."""
    on_cuda = device.type == "cuda"
    if compute_dtype == "auto":
        compute_dtype = "bf16" if on_cuda else "f32"
    if compute_dtype not in DTYPES:
        raise ValueError(f"Unknown compute_dtype {compute_dtype!r}")
    if vocoder_backend not in VOCODER_BACKENDS:
        raise ValueError(f"Unknown vocoder_backend {vocoder_backend!r}")
    if vocoder_backend == "auto":
        vocoder_backend = "cuda" if on_cuda else "torch"
    return vocoder_backend, compute_dtype


def make_vocoder_fn(model: M2TTS, vocoder_backend: str, compute_dtype: str
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The packed-weight vocoder dispatch ``vf(mel) -> audio`` (f32 mel
    [B, T, C] → f32 audio [B, T·U]) for the 'mm' and 'cuda' backends.

    One definition for the batch (``Synthesizer``) and streaming
    (``StreamingVocoder``) paths, so the two cannot drift in backend or
    dtype. The weights of ``model.vocoder`` are packed for
    ``compute_dtype`` at the first call and kept; a caller whose weights
    change makes a new ``vf``. 'cuda' needs the model on a CUDA device and
    builds and probes the kernels here (raising on failure); its ``vf``
    launches ``vocoder_tc.cu`` (bf16) or ``vocoder_tc32.cu`` (f32).
    """
    if compute_dtype not in DTYPES:
        raise ValueError(f"Unknown compute_dtype {compute_dtype!r}")
    if vocoder_backend == "cuda":
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise ValueError("vocoder_backend='cuda' needs the model on a "
                             f"CUDA device, got {device}")
        from m2tts_tpu_torch.ops.cuda.build import kernels_available

        kernels_available()  # builds and probes; raises on failure
    elif vocoder_backend != "mm":
        raise ValueError(f"Unknown vocoder_backend {vocoder_backend!r} "
                         "for the packed-weight vocoder")
    rates = model.upsample_rates
    packed: Optional[Dict] = None

    def vf(mel: torch.Tensor) -> torch.Tensor:
        nonlocal packed
        if packed is None:
            packed = pack_vocoder_weights(model.vocoder, compute_dtype)
        if vocoder_backend == "mm":
            return vocoder_mm_forward(mel, packed, compute_dtype)
        from m2tts_tpu_torch.ops.cuda.vocoder import fused_vocoder_forward

        return fused_vocoder_forward(mel.contiguous(), packed, rates,
                                     compute_dtype)

    return vf


class Synthesizer:
    """Bucketed text→waveform engine over one model on one device."""

    def __init__(self, model: M2TTS,
                 text_buckets: Sequence[int] = DEFAULT_TEXT_BUCKETS,
                 frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 sample_rate: int = 22050, hop_length: int = 256,
                 extra_lexicon=None, vocoder_backend: str = "auto",
                 compute_dtype: str = "auto", device="cuda"):
        """``vocoder_backend``: 'torch' (the ``Vocoder`` module), 'mm' (the
        packed-matmul plain version of the fused kernel), 'cuda' (the fused
        kernel, ``ops/cuda/vocoder.py``) or 'auto' ('cuda' when the model
        is on a CUDA device, 'torch' on the CPU).

        ``compute_dtype``: 'bf16' runs the synthesis in bfloat16 (a bf16
        copy of the model; the packed-weight vocoders take bf16 matmul
        inputs with f32 accumulation); 'auto' = bf16 on CUDA, f32 on the
        CPU. The duration probe always runs in f32 on the model's device,
        so frame counts do not move with the dtype, and PCM quantisation
        is always f32.

        ``device`` defaults to CUDA and raises without it; the model is
        moved there.
        """
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.text_buckets = tuple(text_buckets)
        self.frame_buckets = tuple(frame_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.extra_lexicon = dict(extra_lexicon or {})
        self.text_processor = TextProcessor(extra_lexicon=extra_lexicon)
        self.upsample = model.total_upsample

        self.vocoder_backend, self.compute_dtype = resolve_backend(
            vocoder_backend, compute_dtype, self.device)
        self.config: Optional[Config] = None
        self._drop_caches()

    def _drop_caches(self) -> None:
        """Forget every derived copy of the weights (bf16 model, packed
        vocoder weights)."""
        self._bf16_model: Optional[M2TTS] = None
        self._vocode = (None if self.vocoder_backend == "torch" else
                        make_vocoder_fn(self.model, self.vocoder_backend,
                                        self.compute_dtype))

    def _synth_model(self) -> M2TTS:
        if self.compute_dtype == "f32":
            return self.model
        if self._bf16_model is None:
            self._bf16_model = copy.deepcopy(self.model).to(torch.bfloat16)
        return self._bf16_model

    # -- device work --------------------------------------------------------
    def _to_device(self, packed: np.ndarray):
        t = torch.from_numpy(packed).to(self.device, non_blocking=True)
        return t[:, :-1], t[:, -1]

    @torch.no_grad()
    def predict_frames(self, ids: np.ndarray, lengths: np.ndarray,
                       duration_scale: float = 1.0) -> np.ndarray:
        """Per-utterance frame counts from the f32 duration probe."""
        packed = np.concatenate([np.asarray(ids, np.int32),
                                 np.asarray(lengths, np.int32)[:, None]], 1)
        return self._probe(*self._to_device(packed),
                           duration_scale).cpu().numpy()

    def _probe(self, ids, lengths, duration_scale: float) -> torch.Tensor:
        m = self.model
        enc, mask = m.text_encoder(ids, lengths)
        durations = m.duration_predictor(enc) * mask.to(torch.float32)
        scale = torch.tensor(duration_scale, dtype=torch.float32)
        frames = torch.floor(durations * scale).to(torch.int32)
        return frames.clamp_min(0).sum(dim=1)

    def _run(self, ids, lengths, duration_scale: float, max_frames: int,
             want_mel: bool, pcm_format: str) -> Dict[str, torch.Tensor]:
        model = self._synth_model()
        if self.vocoder_backend == "torch":
            out = model.synthesize(ids, lengths, duration_scale, max_frames)
            audio = out["audio_output"][..., 0]
        else:
            out = model.acoustic(ids, lengths, duration_scale, max_frames)
            audio = self._vocode(out["mel_output"].float())
        audio = audio.float()
        pcm = (torch.clamp(audio, -1.0, 1.0) * 32767.0).to(torch.int16)
        if pcm_format == "mulaw":
            pcm = mulaw_encode_pcm16(pcm)
        result = {"pcm": pcm, "total_frames": out["total_frames"]}
        if want_mel:
            result["mel"] = out["mel_output"].float()
        return result

    @torch.no_grad()
    def _launch(self, texts: List[str], duration_scale: float,
                max_frames: Optional[int], want_mel: bool,
                pcm_format: str = "int16"):
        """Enqueue one batch on the device; returns (outputs, max_frames)."""
        if pcm_format not in ("int16", "mulaw"):
            raise ValueError(f"Unknown pcm_format {pcm_format!r}")
        packed = encode_packed_batch(self.text_processor, texts,
                                     self.batch_buckets, self.text_buckets)
        ids, lengths = self._to_device(packed)
        if max_frames is None:
            totals = self._probe(ids, lengths, duration_scale).cpu().numpy()
            max_frames = _bucket_for(int(totals[: len(texts)].max()),
                                     self.frame_buckets)
        out = self._run(ids, lengths, duration_scale, max_frames, want_mel,
                        pcm_format)
        return out, max_frames

    def _collect(self, out, max_frames: int, n: int, want_mel: bool,
                 pcm_only: bool = False) -> List[Dict[str, np.ndarray]]:
        host = {k: v.cpu().numpy() for k, v in out.items()}
        pcm = host["pcm"]  # [B, samples] int16 (or uint8 μ-law)
        mulaw = pcm.dtype == np.uint8
        totals = host["total_frames"]
        mel = host["mel"] if want_mel else None
        results = []
        for i in range(n):
            frames = int(min(totals[i], max_frames))
            trimmed = pcm[i, : frames * self.upsample]
            if mulaw:
                res = {"audio_mulaw": trimmed, "frames": frames}
                if not pcm_only:
                    trimmed = mulaw_decode_np(trimmed)
                    res["audio_pcm"] = trimmed
            else:
                res = {"audio_pcm": trimmed, "frames": frames}
            if int(totals[i]) > max_frames:
                # the predicted length exceeds the largest frame bucket: the
                # audio is cut off mid-utterance; say so
                res["truncated"] = True
                logger.warning(
                    "Utterance %d predicted %d frames but the frame bucket "
                    "caps at %d — audio truncated (raise the frame buckets "
                    "or split the text)", i, int(totals[i]), max_frames)
            if not pcm_only:
                res["audio"] = trimmed.astype(np.float32) / 32767.0
            if want_mel:
                res["mel"] = mel[i, :frames]
            results.append(res)
        return results

    # -- public API ---------------------------------------------------------
    def synthesize_batch(self, texts: List[str], duration_scale: float = 1.0,
                         max_frames: Optional[int] = None,
                         want_mel: bool = False, pcm_format: str = "int16"
                         ) -> List[Dict[str, np.ndarray]]:
        """Per-utterance dicts with trimmed ``audio`` (float32),
        ``audio_pcm`` (int16), ``frames``, ``mel`` when ``want_mel``, and
        ``audio_mulaw`` under ``pcm_format='mulaw'``."""
        if not texts:
            return []
        out, max_frames = self._launch(texts, duration_scale, max_frames,
                                       want_mel, pcm_format)
        return self._collect(out, max_frames, len(texts), want_mel)

    def synthesize_stream(self, batches: Iterable[List[str]],
                          duration_scale: float = 1.0,
                          max_frames: Optional[int] = None,
                          want_mel: bool = False, pcm_only: bool = False,
                          pcm_format: str = "int16"
                          ) -> Iterator[List[Dict[str, np.ndarray]]]:
        """Bulk synthesis with batch i+1 enqueued before batch i's results
        are copied to the host. ``pcm_only`` skips the float32 waveform."""
        pending = None  # (out, max_frames, n)
        for texts in batches:
            launched = (*self._launch(texts, duration_scale, max_frames,
                                      want_mel, pcm_format), len(texts))
            if pending is not None:
                yield self._collect(*pending, want_mel, pcm_only)
            pending = launched
        if pending is not None:
            yield self._collect(*pending, want_mel, pcm_only)

    def synthesize(self, text: str, duration_scale: float = 1.0,
                   want_mel: bool = False, pcm_format: str = "int16"
                   ) -> Dict[str, np.ndarray]:
        return self.synthesize_batch([text], duration_scale,
                                     want_mel=want_mel,
                                     pcm_format=pcm_format)[0]

    # -- long-form synthesis --------------------------------------------------
    def phoneme_budget(self) -> int:
        """Largest utterance (in phonemes) a single bucket can carry."""
        return max(self.text_buckets)

    def split_text(self, text: str) -> List[str]:
        """Split ``text`` into chunks that each fit the phoneme budget."""
        return split_text_to_budget(text, self.text_processor,
                                    self.phoneme_budget() - 2)

    @torch.no_grad()
    def swap_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Replace the serving weights with a state dict of identical keys,
        shapes and dtypes; every derived copy (bf16 model, packed vocoder
        weights) is dropped and rebuilt from the new weights."""
        current = self.model.state_dict()
        if set(state_dict) != set(current):
            raise ValueError(
                "state dict keys differ: missing "
                f"{sorted(set(current) - set(state_dict))}, unexpected "
                f"{sorted(set(state_dict) - set(current))}")
        for k, v in state_dict.items():
            if tuple(v.shape) != tuple(current[k].shape) \
                    or v.dtype != current[k].dtype:
                raise ValueError(
                    f"param {k} mismatch: got {tuple(v.shape)}/{v.dtype}, "
                    f"serving {tuple(current[k].shape)}/{current[k].dtype}")
        self.model.load_state_dict(state_dict)
        self._drop_caches()

    def synthesize_long(self, text: str, duration_scale: float = 1.0,
                        gap_ms: float = 120.0) -> Dict[str, np.ndarray]:
        """Text of any length → one waveform: split to the phoneme budget,
        one bucketed batch over all chunks, joined with ``gap_ms`` of
        silence."""
        return self.synthesize_batch_long([text], duration_scale, gap_ms)[0]

    def synthesize_batch_long(self, texts: List[str],
                              duration_scale: float = 1.0,
                              gap_ms: float = 120.0
                              ) -> List[Dict[str, np.ndarray]]:
        """``synthesize_batch`` without the phoneme-budget cliff: each text
        is split to the budget, all chunks run through the batch path
        together, and each text's audio is joined with ``gap_ms`` of
        silence between chunks."""
        per_text = [self.split_text(t) for t in texts]
        flat = [c for chunks in per_text for c in chunks]
        max_b = max(self.batch_buckets)
        results: List[Dict[str, np.ndarray]] = []
        for i in range(0, len(flat), max_b):
            results.extend(self.synthesize_batch(flat[i:i + max_b],
                                                 duration_scale))
        gap = np.zeros(int(self.sample_rate * gap_ms / 1000.0), np.float32)
        out: List[Dict[str, np.ndarray]] = []
        k = 0
        for chunks in per_text:
            rs = results[k: k + len(chunks)]
            k += len(chunks)
            if len(rs) == 1:
                rs[0]["chunks"] = chunks
                out.append(rs[0])
                continue
            pieces: List[np.ndarray] = []
            for j, r in enumerate(rs):
                if j:
                    pieces.append(gap)
                pieces.append(r["audio"])
            audio = (np.concatenate(pieces) if pieces
                     else np.zeros(0, np.float32))
            res = {
                "audio": audio,
                "audio_pcm": (np.clip(audio, -1, 1) * 32767).astype(np.int16),
                "chunks": chunks,
                "frames": int(sum(r["frames"] for r in rs)),
            }
            if any(r.get("truncated") for r in rs):
                res["truncated"] = True
            out.append(res)
        return out

    def reachable_shapes(self, full: bool = True):
        """Every (batch, text, frames) shape a request can select;
        ``full=False`` keeps the smallest batch bucket only."""
        single = min(self.batch_buckets)
        batches = list(self.batch_buckets) if full else []
        if single not in batches:
            batches = [single] + batches
        return [(b, t, f) for b in batches for t in self.text_buckets
                for f in self.frame_buckets]

    @torch.no_grad()
    def warmup(self, full: bool = False, want_mel: bool = False) -> int:
        """Run every reachable shape once (builds the kernels, fills the
        allocator's pools); returns the number of shapes run."""
        n = 0
        for b, t, frames in self.reachable_shapes(full):
            packed = np.zeros((b, t + 1), np.int32)
            packed[:, -1] = 1
            ids, lengths = self._to_device(packed)
            self._probe(ids, lengths, 1.0)
            self._run(ids, lengths, 1.0, frames, want_mel, "int16")
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n


def from_config(config, seed: int = 0, vocoder_backend: str = "auto",
                device="cuda", **kwargs) -> Synthesizer:
    """Synthesizer with freshly initialised (untrained) weights, made from
    ``torch.Generator().manual_seed(seed)``. ``config`` is a full config
    (``Config`` or dict with a ``model`` section) or a bare model section
    such as ``FLAGSHIP_MODEL``."""
    cfg = config if isinstance(config, Config) else Config(dict(config))
    model_cfg = cfg.get("model", cfg)
    dev = resolve_device(device)
    model = init_params(build_model(model_cfg),
                        torch.Generator().manual_seed(seed), dev)
    synth = Synthesizer(model,
                        sample_rate=int(cfg.get("data.sample_rate", 22050)),
                        hop_length=int(cfg.get("data.hop_length", 256)),
                        vocoder_backend=vocoder_backend, device=dev, **kwargs)
    synth.config = cfg
    return synth


def from_checkpoint(checkpoint_dir, step=None, vocoder_backend: str = "auto",
                    device="cuda", **kwargs) -> Synthesizer:
    """Synthesizer from a self-describing checkpoint directory written by
    ``utils.checkpoint.CheckpointManager`` (``step``: an int, None for the
    latest, or "best")."""
    state_dict, cfg, _ = load_for_inference(checkpoint_dir, step)
    model = build_model(cfg.get("model", Config()))
    model.load_state_dict(state_dict)
    synth = Synthesizer(model,
                        sample_rate=int(cfg.get("data.sample_rate", 22050)),
                        hop_length=int(cfg.get("data.hop_length", 256)),
                        vocoder_backend=vocoder_backend, device=device,
                        **kwargs)
    synth.config = cfg
    return synth


def from_torch_checkpoint(path, vocoder_backend: str = "auto",
                          device="cuda", **kwargs) -> Synthesizer:
    """Synthesizer from a reference PyTorch checkpoint (the original
    m2-tts layout; ``utils/torch_compat.py``). Converted models always use
    the BatchNorm-compat duration predictor (running stats folded to an
    affine). The file embeds its config object, so it is read with
    ``weights_only=False``: load only files you trust."""
    from m2tts_tpu_torch.utils.params import from_flax
    from m2tts_tpu_torch.utils.torch_compat import \
        convert_reference_checkpoint

    dev = resolve_device(device)
    params, cfg = convert_reference_checkpoint(path)
    cfg = Config(cfg if isinstance(cfg, dict) else {})
    model_cfg = cfg.get("model", Config())
    model_cfg.set("duration_predictor.norm", "batch")
    model = build_model(model_cfg)
    model.load_state_dict(from_flax(params))
    synth = Synthesizer(model,
                        sample_rate=int(cfg.get("data.sample_rate", 22050)),
                        hop_length=int(cfg.get("data.hop_length", 256)),
                        vocoder_backend=vocoder_backend, device=dev,
                        **kwargs)
    synth.config = cfg
    return synth
