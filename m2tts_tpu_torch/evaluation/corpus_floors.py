"""STOI floors and ceilings of a synthetic corpus: the numbers that decide
whether a quality run on it can show training-driven improvement.

The port's counterpart of ``scripts/corpus_floors.py`` (same flags, draw
order, JSON keys and rounding), on the port's ``frontend.audio``,
``evaluation.metrics`` and ``evaluation.stoi``. Over the first N
utterances:

  noise_floor     STOI(white noise, GT): what an envelope-free signal
                  scores for free (through STOI's SDR clip in quiet bands).
  passthrough     STOI(noise under the utterance's overall energy envelope,
                  GT): the best a per-band-blind system can do.
  oracle_f0       STOI(the same text rendered at another F0 shift, GT): the
                  ceiling for a model that learns text→formant placement
                  but not the per-utterance pitch draw (``--profile v3``).
  mel_oracle      STOI(Griffin-Lim of the GT mel, GT) (``--mel-oracle``).
  lsd_noise, lsd_passthrough   log-spectral distance of the first two legs.

    python -m m2tts_tpu_torch.evaluation.corpus_floors \\
        --data-dir data/synthetic-v3-1000 --n 16 --profile v3 --json out.json

Host NumPy only; no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from m2tts_tpu_torch.evaluation.metrics import compute_log_spectral_distance
from m2tts_tpu_torch.evaluation.stoi import compute_stoi
from m2tts_tpu_torch.frontend.audio import load_wav


def global_envelope_noise(audio: np.ndarray, rng, sr: int,
                          win_ms: float = 20.0) -> np.ndarray:
    """White noise modulated by the utterance's OVERALL energy envelope —
    the best any per-band-blind (passthrough) system can do."""
    w = max(int(sr * win_ms / 1000.0), 1)
    env = np.sqrt(np.convolve(audio ** 2, np.ones(w) / w, "same") + 1e-12)
    noise = rng.standard_normal(len(audio))
    return (env * noise).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="STOI floors of a synthetic corpus (PyTorch port)")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--profile", default=None,
                    help="v3 enables the oracle_f0 leg (re-render)")
    ap.add_argument("--mel-oracle", action="store_true",
                    help="add Griffin-Lim-from-GT-mel STOI (vocoder-"
                         "perfect ceiling given the mel representation)")
    ap.add_argument("--n-mels", type=int, default=80,
                    help="mel channels for --mel-oracle (training config)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    corpus = Path(args.data_dir)
    rows = [ln.split("|") for ln in
            (corpus / "metadata.csv").read_text().splitlines() if ln][: args.n]
    rng = np.random.default_rng(0)

    legs = {"noise_floor": [], "passthrough": [], "lsd_noise": [],
            "lsd_passthrough": []}
    if args.mel_oracle:
        from m2tts_tpu_torch.frontend.audio import AudioProcessor

        legs["mel_oracle"] = []
        proc = AudioProcessor(n_mels=args.n_mels, fmax=11025.0)
    if args.profile == "v3":
        from m2tts_tpu_torch.data.download_data import _render_utterance_v3
        from m2tts_tpu_torch.frontend.text import TextProcessor

        legs["oracle_f0"] = []
        tp = TextProcessor()

    for fid, text, _ in rows:
        audio, sr = load_wav(corpus / "wavs" / f"{fid}.wav")
        audio = np.asarray(audio, np.float64)
        n = len(audio)
        white = rng.standard_normal(n)
        legs["noise_floor"].append(compute_stoi(audio, white, sr))
        legs["lsd_noise"].append(
            compute_log_spectral_distance(audio, white))
        pt = global_envelope_noise(audio, rng, sr)
        legs["passthrough"].append(compute_stoi(audio, pt, sr))
        legs["lsd_passthrough"].append(
            compute_log_spectral_distance(audio, pt))
        if "mel_oracle" in legs:
            gl = proc.mel_to_audio(proc.compute_mel(audio))
            m = min(len(gl), n)
            legs["mel_oracle"].append(compute_stoi(audio[:m], gl[:m], sr))
        if "oracle_f0" in legs:
            content = [p for p in tp.text_to_phonemes(text) if p != "SIL"]
            dur_s = n / sr / max(len(content), 1)
            alt = _render_utterance_v3(content, dur_s, sr,
                                       f0_shift=1.12, rng=rng)
            m = min(len(alt), n)
            alt = 0.8 * alt[:m] / max(np.abs(alt[:m]).max(), 1e-6)
            legs["oracle_f0"].append(compute_stoi(audio[:m], alt, sr))

    out = {k: round(float(np.nanmean(v)), 4) for k, v in legs.items()}
    out["n_utterances"] = len(rows)
    out["corpus"] = str(corpus)
    print(json.dumps(out))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
