"""In-training sample validation: synthesize fixed texts, dump WAVs, score
the heuristic MOS.

Counterpart of ``m2tts_tpu/training/validation.py``. Synthesis runs through
the port's bucketed ``Synthesizer`` on a model the validator owns (of the
trainer's architecture), into which each validation copies the trainer's
current weights (``swap_params``): the trainer's model never leaves
training mode, and the synthesizer is built once.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_EVAL_TEXTS = ["Hello world, this is a test."]


class SampleValidator:
    """Synthesize fixed eval texts with the current weights, write WAVs,
    and return per-sample and mean MOS metrics. ``model`` is the
    validator's own module of the trainer's architecture; ``run`` copies
    the weights to score into it."""

    def __init__(self, model, eval_texts: Optional[Sequence[str]] = None,
                 samples_dir="outputs/samples", sample_rate: int = 22050,
                 hop_length: int = 256, text_bucket: int = 64,
                 frame_bucket: int = 256, device="cuda"):
        self.model = model
        self.eval_texts: List[str] = list(eval_texts or DEFAULT_EVAL_TEXTS)
        self.samples_dir = Path(samples_dir)
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.text_bucket = text_bucket
        self.frame_bucket = frame_bucket
        self.device = torch.device(device)
        self._synth = None
        self._warned_text_trunc = False
        self._warned_frame_clip = False

    def _get_synth(self, state_dict: Dict[str, torch.Tensor]):
        if self._synth is None:
            from m2tts_tpu_torch.serving.pipeline import Synthesizer

            n = len(self.eval_texts)
            self._synth = Synthesizer(
                self.model,
                text_buckets=(self.text_bucket,),
                frame_buckets=(self.frame_bucket,),
                batch_buckets=(max(n, 1),),
                sample_rate=self.sample_rate, hop_length=self.hop_length,
                # The validator's yardstick, pinned as the JAX package pins
                # its validator to the f32 XLA module: the port's
                # counterpart is the `torch` backend (the Vocoder module)
                # in f32 on the trainer's device, so validation scores
                # compare across runs whatever the serving default. It is
                # not a fallback.
                vocoder_backend="torch", compute_dtype="f32",
                device=self.device)
        self._synth.swap_params(
            {k: v.detach() for k, v in state_dict.items()})
        return self._synth

    def run(self, state_dict: Dict[str, torch.Tensor], step: int
            ) -> Dict[str, float]:
        """Synthesize, dump ``sample_step_{step}_text_{i}.wav``, score MOS.

        A failed synthesis logs a warning and returns what it has, so a
        validation never stops training."""
        from m2tts_tpu_torch.evaluation.metrics import estimate_mos_score
        from m2tts_tpu_torch.frontend.audio import save_wav

        metrics: Dict[str, float] = {}
        try:
            synth = self._get_synth(state_dict)
            self._warn_if_truncating(synth)
            results = synth.synthesize_batch(
                self.eval_texts, max_frames=self.frame_bucket)
        except Exception:
            logger.warning("Sample synthesis failed at step %d", step,
                           exc_info=True)
            return metrics
        # an eval utterance whose predicted frames hit the bucket cap is
        # clipped: its WAV and MOS cover only the first frame_bucket frames
        clipped = [i for i, r in enumerate(results)
                   if r["frames"] >= self.frame_bucket]
        if clipped and not self._warned_frame_clip:
            self._warned_frame_clip = True
            logger.warning(
                "eval text(s) %s hit the %d-frame validation bucket — "
                "their sample WAVs/MOS are clipped; raise "
                "system.eval_frame_bucket to cover full utterances",
                clipped, self.frame_bucket)
        self.samples_dir.mkdir(parents=True, exist_ok=True)
        mos_scores = []
        for i, r in enumerate(results):
            try:
                path = self.samples_dir / f"sample_step_{step}_text_{i}.wav"
                save_wav(r["audio"], path, self.sample_rate)
                mos = estimate_mos_score(
                    r["audio"], sample_rate=self.sample_rate)["estimated_mos"]
                metrics[f"sample_{i}_mos"] = mos
                mos_scores.append(mos)
            except Exception:
                logger.warning("Failed to save/score sample %d", i,
                               exc_info=True)
        if mos_scores:
            metrics["estimated_mos"] = float(np.mean(mos_scores))
        metrics["validation_completed"] = 1.0
        return metrics

    def _warn_if_truncating(self, synth) -> None:
        """Warn (once) when an eval text exceeds the text bucket: the
        frontend would truncate it to text_bucket phonemes."""
        if self._warned_text_trunc:
            return
        over = []
        for i, t in enumerate(self.eval_texts):
            n = len(synth.text_processor.text_to_phonemes(t))
            if n > self.text_bucket:
                over.append((i, n))
        if over:
            self._warned_text_trunc = True
            logger.warning(
                "eval text(s) %s exceed the %d-phoneme validation bucket "
                "and will be TRUNCATED; raise system.eval_text_bucket",
                over, self.text_bucket)


def validator_from_config(config, model, stage: int,
                          device="cuda") -> SampleValidator:
    """A SampleValidator from the 5-group config schema."""
    out_dir = Path(config.get(
        "paths.output_dir", f"outputs/stage{stage}"))
    samples_dir = config.get("paths.samples_dir", out_dir / "samples")
    texts = config.get("system.eval_texts", None)
    return SampleValidator(
        model, eval_texts=texts, samples_dir=samples_dir,
        sample_rate=int(config.get("data.sample_rate", 22050)),
        hop_length=int(config.get("data.hop_length", 256)),
        text_bucket=int(config.get("system.eval_text_bucket", 64)),
        frame_bucket=int(config.get("system.eval_frame_bucket", 256)),
        device=device)
