"""Set-up and checking shared by the serving drivers: the weights and texts
from the seed, the duration scale, the program built from them, and the
reference's audio for a served request.

The duration scale is calibrated on the benchmark's own float32 reference
(the weights are random, so lengths come from the scale): the one scale
that makes the texts' summed frames what the mix's speaking rate asks for.
So the traffic does not depend on the program's arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import traffic
from portbench.reference import model as ref
from portbench.reference.quant import ROUNDINGS
from portbench.reference.text import TextProcessor
from portbench.weights import make_state_dict

REF_BLOCK = 256  # texts a reference call encodes at once


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


class Cell:
    """What a run of a serving cell is made of, from the seed."""

    def __init__(self, config: Dict, mix: Dict, seed: int, device,
                 n_texts: int, mark=lambda what: None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.sizes = ref.Sizes(config["model"])
        self.serving = config["serving"]
        self.sr = int(config["data"]["sample_rate"])
        self.hop = int(config["data"]["hop_length"])
        self.sd = make_state_dict(config["model"], seed, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        mark("weights")
        targets = traffic.arranged(mix, n_texts,
                                   traffic.rng_for(seed, "order"))
        self.texts = traffic.TextMaker().texts(targets,
                                               traffic.rng_for(seed, "words"))
        self.tp = TextProcessor()
        self.phonemes = np.array([len(self.tp.text_to_phonemes(t))
                                  for t in self.texts])
        mark("texts_g2p")
        self.scale, self.totals = self._calibrate()
        mark("calibration")
        if self.device.type == "cuda":  # the program's peak is its own
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    # -- the reference -------------------------------------------------------
    def encode(self, texts: List[str], bucket: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = max(len(self.tp.text_to_phonemes(t)) for t in texts)
        b = bucket or bucket_for(n, self.serving["text_buckets"])
        enc = self.tp.batch(texts, b)
        return (torch.from_numpy(enc["phoneme_ids"]).to(self.device),
                torch.from_numpy(enc["lengths"]).to(self.device))

    @torch.no_grad()
    def _durations(self) -> List[np.ndarray]:
        """Each text's masked float32 durations (before the scale)."""
        order = np.argsort(self.phonemes)
        out: List[np.ndarray] = [None] * len(self.texts)
        with ref.exact():
            for i in range(0, len(order), REF_BLOCK):
                idx = order[i:i + REF_BLOCK]
                ids, lengths = self.encode([self.texts[j] for j in idx],
                                           int(self.phonemes[idx].max()))
                enc, mask = ref.encode(self.sd, self.sizes, ids, lengths)
                dur = (ref.durations(self.sd, enc) * mask.float()).cpu().numpy()
                for j, row in zip(idx, dur):
                    out[j] = row
        return out

    def _calibrate(self) -> Tuple[float, np.ndarray]:
        durs = self._durations()
        frames_per_s = self.sr / self.hop
        target = float(self.phonemes.sum()) / float(
            self.mix["phonemes_per_s"]) * frames_per_s
        scale = target / sum(float(d.sum()) for d in durs)
        for _ in range(6):  # floor() makes frames nonlinear in the scale
            s32 = np.float32(scale)
            got = sum(int(np.floor(d * s32).sum()) for d in durs)
            scale *= target / max(got, 1)
        scale = float(np.float32(scale))
        totals = np.array([int(np.floor(d * np.float32(scale)).sum())
                           for d in durs])
        return scale, totals

    @staticmethod
    def rounding(name: Optional[str]):
        """(operand rounding, activation rounding) of a control."""
        same = lambda x: x  # noqa: E731
        return ROUNDINGS[name] if name else (same, same)

    @torch.no_grad()
    def batch_audio(self, call: List[str], rows: List[int],
                    served_bucket: int, control: Optional[str] = None,
                    guard: int = 2) -> List[np.ndarray]:
        """The reference's audio (float, PCM-quantised) of ``rows`` of one
        batch call, as ``Synthesizer.synthesize_batch`` makes it: the frame
        bucket from the float32 probe over the whole call, the synthesis at
        that bucket, trimmed. Where the call's longest utterance lies within
        ``guard`` frames of a bucket's edge, either bucket is sound and the
        served one is used. ``control``: the rounding of the synthesis."""
        q, qa = self.rounding(control)
        fb = self.serving["frame_buckets"]
        with ref.exact():
            ids, lengths = self.encode(call)
            peak = int(ref.totals(self.sd, self.sizes, ids, lengths,
                                  self.scale).max())
            bucket = bucket_for(peak, fb)
            near = {bucket_for(max(peak - guard, 0), fb),
                    bucket_for(peak + guard, fb)}
            if served_bucket in near:
                bucket = served_bucket
            r = torch.tensor(rows, device=self.device)
            mel, total = ref.mel_for(self.sd, self.sizes, ids[r], lengths[r],
                                     self.scale, bucket, q, qa)
            audio = ref.vocode(self.sd, self.sizes, mel, q, qa)
            pcm = ref.pcm16(audio).cpu().numpy()
        U = self.sizes.upsample
        return [pcm[i, : int(min(t, bucket)) * U].astype(np.float32) / 32767.0
                for i, t in enumerate(total.tolist())]

    @torch.no_grad()
    def stream_audio(self, text: str, window: int,
                     control: Optional[str] = None) -> np.ndarray:
        """The reference's audio of one stream, as ``StreamingSynthesizer``
        makes it: the acoustic pass at the largest text and frame buckets,
        the mel cut to the utterance's frames and vocoded whole (an
        utterance within one ``window`` by the float32 short path)."""
        tb, fb = (max(self.serving["text_buckets"]),
                  max(self.serving["frame_buckets"]))
        q, qa = self.rounding(control)
        with ref.exact():
            ids, lengths = self.encode([text], tb)
            mel, total = ref.mel_for(self.sd, self.sizes, ids, lengths,
                                     self.scale, fb, q, qa)
            T = int(min(int(total[0]), fb))
            vq, vqa = self.rounding("tf32" if control and T <= window
                                    else control)
            audio = ref.vocode(self.sd, self.sizes, mel[:, :T], vq, vqa)
        return audio[0].float().cpu().numpy()

    # -- the program ---------------------------------------------------------
    def build_synthesizer(self):
        """The port's ``Synthesizer`` on this cell's weights, configured as
        the configuration states."""
        from m2tts_tpu_torch.models.tts_model import build_model
        from m2tts_tpu_torch.serving.pipeline import Synthesizer

        model = build_model(self.config["model"]).to(self.device)
        model.load_state_dict(self.sd)
        sv = self.serving
        return Synthesizer(
            model, text_buckets=tuple(sv["text_buckets"]),
            frame_buckets=tuple(sv["frame_buckets"]),
            batch_buckets=tuple(sv["batch_buckets"]),
            sample_rate=self.sr, hop_length=self.hop,
            vocoder_backend=sv["vocoder_backend"],
            compute_dtype=sv["compute_dtype"], device=self.device,
            frame_probe=sv["frame_probe"])


def pick_sample(cell: "Cell", n: int) -> set:
    """The requests (by index) whose answers the check compares: the mix's
    ``sample`` of the ``n`` drawn from the seed, and always the longest and
    the shortest by the reference's frames (the shortest, in the longest
    frame context, is where bfloat16 strays furthest)."""
    rng = traffic.rng_for(cell.seed, "sample")
    size = min(int(cell.mix["sample"]), n)
    return (set(rng.choice(n, size=size, replace=False).tolist())
            | {int(np.argmax(cell.totals)), int(np.argmin(cell.totals))})


def free_device(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
