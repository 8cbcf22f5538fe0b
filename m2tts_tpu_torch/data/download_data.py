"""Dataset CLI of the PyTorch port: LJSpeech download, extraction and
verification, its first-N subset, and the synthetic corpus.

The port of ``scripts/download_data.py``, with its names, flags and on-disk
layout (``metadata.csv`` + ``wavs/*.wav``, which ``TTSDataset`` reads), on
the port's own ``frontend.audio`` and ``frontend.text``:

  (default)       make ``data_dir/LJSpeech-1.1``: a verified tree is kept;
                  else ``data_dir/LJSpeech-1.1.tar.bz2`` is extracted and
                  verified, and fetched from ``LJSPEECH_URL`` first only
                  when it is absent (a failed fetch exits 1), so a machine
                  without network builds the tree from an archive it was
                  given; ``--subset-size N`` then builds its first-N subset

  --synthetic N   build an N-utterance synthetic corpus whose audio is a
                  deterministic function of the text's phonemes
                  (``data_dir/synthetic-{profile}-{N}``; v1:
                  ``synthetic-{N}``). The same N and profile give the same
                  bytes as the JAX package's script: the same
                  ``default_rng(42)`` draws in the same order, the same
                  peak normalisation, the same G2P and WAV writer.
  --verify-only   check an LJSpeech tree (``data_dir/LJSpeech-1.1``) and
                  touch no network (with ``--subset-size``, build its
                  first-N subset too)

    python -m m2tts_tpu_torch.data.download_data --synthetic 1000 \\
        --data-dir data --synthetic-profile v3

The render is serial on the host: the v3 renderer draws its aspiration
noise from the corpus's one generator inside each utterance.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import sys
import tarfile
import urllib.request
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

LJSPEECH_URL = "https://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2"
LJSPEECH_DIRNAME = "LJSpeech-1.1"
PROFILES = ("v1", "v2", "v3")


def download_file(url: str, output_path: Path) -> None:
    """Stream a URL to disk with a progress line on stderr; the transfer
    goes to ``<output>.part``, renamed on success, so an interrupted one
    leaves no archive that a retry would take as whole."""
    output_path.parent.mkdir(parents=True, exist_ok=True)

    def report(blocks, block_size, total):
        done = blocks * block_size
        if total > 0:
            pct = min(100.0, 100.0 * done / total)
            sys.stderr.write(f"\r  {done / 1e6:8.1f} MB / {total / 1e6:.1f} MB ({pct:5.1f}%)")
        else:
            sys.stderr.write(f"\r  {done / 1e6:8.1f} MB")
        sys.stderr.flush()

    print(f"Downloading {url} -> {output_path}")
    part = output_path.with_suffix(output_path.suffix + ".part")
    try:
        urllib.request.urlretrieve(url, part, reporthook=report)
    except BaseException:
        part.unlink(missing_ok=True)
        raise
    part.rename(output_path)
    sys.stderr.write("\n")


def extract_archive(archive_path: Path, extract_to: Path) -> None:
    print(f"Extracting {archive_path} -> {extract_to}")
    with tarfile.open(archive_path) as tar:
        # 'data': no member may land outside ``extract_to``
        tar.extractall(extract_to, filter="data")


def verify_ljspeech(ljspeech_dir: Path) -> bool:
    """Check metadata.csv exists and every referenced wav is present."""
    meta = ljspeech_dir / "metadata.csv"
    wavs = ljspeech_dir / "wavs"
    if not meta.exists() or not wavs.is_dir():
        print(f"MISSING: {meta if not meta.exists() else wavs}")
        return False
    missing = 0
    total = 0
    with open(meta, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            total += 1
            if not (wavs / f"{parts[0]}.wav").exists():
                missing += 1
    print(f"metadata entries: {total}, missing wavs: {missing}")
    return missing == 0 and total > 0


def create_ljspeech_subset(ljspeech_dir: Path, subset_size: int) -> Path:
    """First-N subset with the same layout, hard-linking wavs when possible."""
    subset_dir = ljspeech_dir.parent / f"{ljspeech_dir.name}-subset-{subset_size}"
    subset_wavs = subset_dir / "wavs"
    subset_wavs.mkdir(parents=True, exist_ok=True)

    kept = []
    with open(ljspeech_dir / "metadata.csv", encoding="utf-8") as f:
        for line in f:
            if len(kept) >= subset_size:
                break
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            src = ljspeech_dir / "wavs" / f"{parts[0]}.wav"
            if not src.exists():
                continue
            dst = subset_wavs / src.name
            if not dst.exists():
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copy2(src, dst)
            kept.append(line)

    with open(subset_dir / "metadata.csv", "w", encoding="utf-8") as f:
        f.writelines(kept)
    print(f"Subset: {len(kept)} utterances -> {subset_dir}")
    return subset_dir


def _phoneme_signal(ph: str, n_samples: int, sample_rate: int,
                    f0_shift: float) -> np.ndarray:
    """Corpus v1's signature of one phoneme: a hash-keyed harmonic stack
    under one slow AM (voiced), band-shaped noise (unvoiced), or near
    silence (SIL/SP). The text→audio map is deterministic up to the
    per-utterance prosody factors, so an acoustic model can learn it."""
    if ph in ("SIL", "SP"):
        rng = np.random.default_rng(7)
        return (1e-3 * rng.standard_normal(n_samples)).astype(np.float32)
    h = zlib.crc32(ph.encode())
    t = np.arange(n_samples) / sample_rate
    if h % 3 != 0:  # "voiced": harmonic stack with phoneme-specific timbre
        f0 = (95.0 + (h % 181)) * f0_shift
        amps = [1.0, 0.6 + (h >> 3) % 7 / 10.0, 0.3 + (h >> 6) % 5 / 10.0,
                0.15]
        sig = sum(a * np.sin(2 * np.pi * (k + 1) * f0 * t + (h >> k) % 7)
                  for k, a in enumerate(amps))
        # slow formant-ish AM unique to the phoneme
        sig *= 1.0 + 0.25 * np.sin(2 * np.pi * (3.0 + h % 11) * t)
    else:  # "unvoiced": band-limited noise burst
        rng = np.random.default_rng(h)
        noise = rng.standard_normal(n_samples + 32)
        k = 4 + (h >> 4) % 24  # smoothing width sets the band
        kernel = np.hanning(k + 2)[1:-1]
        sig = np.convolve(noise, kernel / kernel.sum(), "same")[:n_samples]
        sig = noise[:n_samples] - sig  # high-pass-ish fricative noise
    return np.asarray(sig, np.float32)


def _phoneme_signal_v2(ph: str, n_samples: int, sample_rate: int,
                       f0_shift: float) -> np.ndarray:
    """Corpus v2's signature of one phoneme: octave-spaced partials
    (k·F0, k ∈ {1, 2, 4, 8}), each under its own hash-keyed slow AM and
    some absent, so band envelopes differ from each other (v1 gave every
    band one envelope, and white noise scored STOI 0.70 against it)."""
    if ph in ("SIL", "SP"):
        rng = np.random.default_rng(7)
        return (1e-3 * rng.standard_normal(n_samples)).astype(np.float32)
    h = zlib.crc32(ph.encode())
    t = np.arange(n_samples) / sample_rate
    if h % 3 != 0:  # voiced: octave-spaced partials, per-partial AM
        f0 = (95.0 + (h % 181)) * f0_shift
        sig = np.zeros(n_samples)
        for j, k in enumerate((1, 2, 4, 8)):
            if j > 0 and ((h >> (5 * j + 1)) % 3) == 0:
                continue  # partial absent for this phoneme
            base = 1.0 / (1.0 + j)  # gentle spectral tilt
            am_rate = 1.5 + ((h >> (3 * j)) % 13) * 0.7   # 1.5-10 Hz
            am_phase = ((h >> (2 * j)) % 17) / 17.0 * 2 * np.pi
            env = 0.2 + 0.8 * (0.5 + 0.5 * np.sin(
                2 * np.pi * am_rate * t + am_phase))
            sig += base * env * np.sin(
                2 * np.pi * k * f0 * t + (h >> j) % 7)
    else:  # unvoiced: AM'd high-pass noise (envelope in the top bands)
        rng = np.random.default_rng(h)
        noise = rng.standard_normal(n_samples + 32)
        kw = 4 + (h >> 4) % 24
        kernel = np.hanning(kw + 2)[1:-1]
        lp = np.convolve(noise, kernel / kernel.sum(), "same")[:n_samples]
        sig = noise[:n_samples] - lp
        am_rate = 2.0 + (h % 11) * 0.8
        sig *= 0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * am_rate * t))
    return np.asarray(sig, np.float32)


# ---------------------------------------------------------------------------
# Corpus v3: speech-like formant synthesis. Every STOI band (150 Hz–4.3 kHz)
# stays active (dense harmonics, a tilt floor, shaped aspiration), band
# envelopes come from moving formants keyed to the phoneme sequence, there
# are no interior silences, durations are uniform within an utterance (so
# the dataset's uniform-duration alignment holds up to a one-slot shift),
# and formants do not follow the per-utterance F0 draw. Measured floors and
# the reasons for each rule: artifacts/evidence_r05/EVIDENCE.md.
# ---------------------------------------------------------------------------

# (F1, F2, F3) targets in Hz — Peterson & Barney / Hillenbrand male means.
_VOWEL_F = {
    "IY": (270, 2290, 3010), "IH": (390, 1990, 2550),
    "EH": (530, 1840, 2480), "AE": (660, 1720, 2410),
    "AA": (730, 1090, 2440), "AO": (570, 840, 2410),
    "UH": (440, 1020, 2240), "UW": (300, 870, 2240),
    "AH": (640, 1190, 2390), "ER": (490, 1350, 1690),
}
# Diphthongs: (start, end) formant targets, interpolated across the phoneme.
_DIPHTHONG_F = {
    "EY": ((530, 1840, 2480), (390, 1990, 2550)),
    "AY": ((730, 1090, 2440), (390, 1990, 2550)),
    "AW": ((730, 1090, 2440), (440, 1020, 2240)),
    "OY": ((570, 840, 2410), (390, 1990, 2550)),
    "OW": ((570, 840, 2410), (300, 870, 2240)),
}
# Consonants: (class, formant loci, fricative noise (centre, width) in Hz).
_CONS = {
    "M":  ("nasal", (250, 1000, 2200), None),
    "N":  ("nasal", (250, 1500, 2500), None),
    "NG": ("nasal", (250, 2000, 2700), None),
    "L":  ("liquid", (360, 1300, 2700), None),
    "R":  ("liquid", (420, 1300, 1690), None),
    "W":  ("glide", (300, 870, 2240), None),
    "Y":  ("glide", (270, 2290, 3010), None),
    "B":  ("vstop", (400, 1000, 2400), (500, 800)),
    "D":  ("vstop", (400, 1700, 2600), (3000, 2000)),
    "G":  ("vstop", (400, 2000, 2500), (1800, 1200)),
    "P":  ("ustop", (400, 1000, 2400), (700, 1000)),
    "T":  ("ustop", (400, 1700, 2600), (3800, 2500)),
    "K":  ("ustop", (400, 2000, 2500), (2000, 1500)),
    "V":  ("vfric", (400, 1000, 2400), (1500, 2500)),
    "DH": ("vfric", (400, 1600, 2500), (2000, 3000)),
    "Z":  ("vfric", (400, 1700, 2600), (4300, 2200)),
    "ZH": ("vfric", (400, 1800, 2500), (3200, 1800)),
    "F":  ("ufric", (400, 1000, 2400), (2500, 3500)),
    "TH": ("ufric", (400, 1600, 2500), (2800, 3500)),
    "S":  ("ufric", (400, 1700, 2600), (4500, 2000)),
    "SH": ("ufric", (400, 1800, 2500), (3000, 1600)),
    "CH": ("affr", (400, 1800, 2500), (3000, 1600)),
    "JH": ("affr", (400, 1800, 2500), (3200, 1800)),
    "HH": ("asp", (500, 1500, 2500), (1200, 3000)),
}
_SCHWA_F = (500, 1500, 2500)  # neutral bridge target (SP, UNK)


def _phoneme_targets(ph: str, h: int):
    """(cls, (F1,F2,F3) start, (F1,F2,F3) end, noise (centre,width) or None,
    per-formant gains) for one phoneme, with a small hash-keyed detune so
    no two phonemes are spectrally identical even within a class."""
    det = 1.0 + ((h % 13) - 6) * 0.01  # ±6 % phoneme-keyed detune
    if ph in _VOWEL_F:
        f = tuple(x * det for x in _VOWEL_F[ph])
        return "vowel", f, f, None, (1.0, 0.63, 0.32)
    if ph in _DIPHTHONG_F:
        a, b = _DIPHTHONG_F[ph]
        return ("vowel", tuple(x * det for x in a),
                tuple(x * det for x in b), None, (1.0, 0.63, 0.32))
    if ph in _CONS:
        cls, loci, noise = _CONS[ph]
        f = tuple(x * det for x in loci)
        gains = {"nasal": (1.0, 0.18, 0.12), "liquid": (1.0, 0.5, 0.3),
                 "glide": (1.0, 0.6, 0.3)}.get(cls, (0.7, 0.5, 0.3))
        return cls, f, f, noise, gains
    return "vowel", _SCHWA_F, _SCHWA_F, None, (0.8, 0.5, 0.3)


def _render_utterance_v3(phonemes, dur_s: float, sample_rate: int,
                         f0_shift: float, rng) -> np.ndarray:
    """Formant-synthesize one utterance: dense harmonics under moving
    formant envelopes + band-shaped noise, uniform phoneme duration.
    Draws ``n_samples`` standard normals from ``rng``."""
    ctrl_hz = 200.0                       # control-track rate
    n_ph = len(phonemes)
    frames_per_ph = max(int(round(dur_s * ctrl_hz)), 4)
    n_ctrl = n_ph * frames_per_ph
    n_samples = int(n_ph * dur_s * sample_rate)

    # --- per-control-frame targets (piecewise within phonemes) ----------
    F = np.zeros((n_ctrl, 3))             # formant centre tracks
    G = np.zeros((n_ctrl, 3))             # per-formant gains
    voic = np.zeros(n_ctrl)               # harmonic mix
    fric = np.zeros(n_ctrl)               # fricative-noise mix
    nc = np.full(n_ctrl, 3000.0)          # noise centre
    nw = np.full(n_ctrl, 2500.0)          # noise width
    amp = np.zeros(n_ctrl)                # overall amplitude
    acc = np.zeros(n_ctrl)                # F0 accent
    for i, ph in enumerate(phonemes):
        h = zlib.crc32(ph.encode())
        cls, fa, fb, noise, gains = _phoneme_targets(ph, h)
        s, e = i * frames_per_ph, (i + 1) * frames_per_ph
        w = np.linspace(0.0, 1.0, frames_per_ph)
        for j in range(3):
            F[s:e, j] = fa[j] + (fb[j] - fa[j]) * w
            G[s:e, j] = gains[j]
        if noise is not None:
            nc[s:e], nw[s:e] = noise
        # class-keyed voicing / noise / amplitude programs
        if cls == "vowel":
            voic[s:e], amp[s:e] = 1.0, 1.0
            fric[s:e] = 0.0
        elif cls in ("nasal", "liquid", "glide"):
            voic[s:e], amp[s:e] = 1.0, 0.75
        elif cls == "vfric":
            voic[s:e], fric[s:e], amp[s:e] = 0.6, 0.5, 0.65
        elif cls == "ufric":
            voic[s:e], fric[s:e], amp[s:e] = 0.0, 1.0, 0.55
        elif cls == "asp":
            voic[s:e], fric[s:e], amp[s:e] = 0.2, 0.8, 0.5
        elif cls in ("vstop", "ustop", "affr"):
            # closure (low, voiced bar if voiced) then burst + decay
            k = max(frames_per_ph // 3, 1)
            voiced = cls == "vstop"
            voic[s:e] = 0.8 if voiced else 0.0
            amp[s:s + k] = 0.12            # closure, NOT full silence
            burst = np.linspace(1.0, 0.45, frames_per_ph - k)
            amp[s + k:e] = burst
            fric[s + k:e] = 1.0 if cls in ("ustop", "affr") else 0.4
            if cls == "affr":
                voic[s + k:e] = 0.3
        if ph == "SP":                    # coarticulated schwa bridge
            voic[s:e], amp[s:e], fric[s:e] = 0.9, 0.55, 0.0
        acc[s:e] = 1.0 + ((h % 9) - 4) * 0.03   # phoneme-keyed accent

    # --- coarticulation: smooth every track across boundaries -----------
    def smooth(x, sigma_s):
        k = int(sigma_s * ctrl_hz * 3) * 2 + 1
        t = (np.arange(k) - k // 2) / (sigma_s * ctrl_hz)
        g = np.exp(-0.5 * t * t)
        g /= g.sum()
        if x.ndim == 1:
            return np.convolve(np.pad(x, (k // 2,), mode="edge"), g, "valid")
        return np.stack([smooth(x[:, j], sigma_s)
                         for j in range(x.shape[1])], 1)

    F = smooth(F, 0.020)                  # ~40 ms formant transitions
    G = smooth(G, 0.015)
    voic = smooth(voic, 0.008)
    fric = smooth(fric, 0.008)
    nc = smooth(nc, 0.015)
    nw = smooth(nw, 0.015)
    amp = smooth(amp, 0.010)
    acc = smooth(acc, 0.040)

    # --- F0 contour: base × speaker shift × declination × accents -------
    t_ctrl = np.arange(n_ctrl) / ctrl_hz
    decl = np.linspace(1.08, 0.90, n_ctrl)
    f0 = 108.0 * f0_shift * decl * acc

    # --- spectral envelope evaluated on the control grid -----------------
    bw = np.array([130.0, 180.0, 240.0])  # formant bandwidths (Hz)

    def envelope(freqs, idx=slice(None)):
        """E(f, t) for freqs [K] on control frames idx → [T, K]."""
        f = np.asarray(freqs)[None, None, :]            # [1,1,K]
        cf = F[idx][:, :, None]                          # [T,3,1]
        g = G[idx][:, :, None]
        r = (g * np.exp(-0.5 * ((f - cf) / bw[None, :, None]) ** 2)).sum(1)
        tilt = 1.0 / (1.0 + (np.asarray(freqs)[None, :] / 3200.0) ** 2)
        return (r + 0.035) * tilt                        # floor: no dead bands

    # --- harmonic part ---------------------------------------------------
    K = 48
    ks = np.arange(1, K + 1)
    # per-harmonic amplitude on the control grid: E(k·f0(t), t)
    fk = f0[:, None] * ks[None, :]                       # [T, K]
    cf = F[:, :, None]
    gf = G[:, :, None]
    rk = (gf * np.exp(-0.5 * ((fk[:, None, :] - cf) / bw[None, :, None]) ** 2)).sum(1)
    ak = (rk + 0.035) / (1.0 + (fk / 3200.0) ** 2)
    ak *= (fk < 8500.0)
    ak *= voic[:, None]

    # upsample control tracks to audio rate
    t_audio = np.arange(n_samples) / sample_rate
    f0_a = np.interp(t_audio, t_ctrl, f0)
    phase = 2.0 * np.pi * np.cumsum(f0_a) / sample_rate
    harm = np.zeros(n_samples)
    phases = (zlib.crc32(b"phase") >> np.arange(K)) % 7  # fixed dispersion
    for k in range(K):
        a = np.interp(t_audio, t_ctrl, ak[:, k])
        if a.max() < 1e-4:
            continue
        harm += a * np.sin((k + 1) * phase + phases[k])

    # --- noise part: fixed log-spaced bands, time-varying mix ------------
    n_bands = 14
    edges = np.geomspace(120.0, 9500.0, n_bands + 1)
    centers = np.sqrt(edges[:-1] * edges[1:])
    white = rng.standard_normal(n_samples)
    spec = np.fft.rfft(white)
    fgrid = np.fft.rfftfreq(n_samples, 1.0 / sample_rate)
    band_sig = np.empty((n_bands, n_samples))
    for b in range(n_bands):
        m = (fgrid >= edges[b]) & (fgrid < edges[b + 1])
        band_sig[b] = np.fft.irfft(spec * m, n_samples)
        band_sig[b] /= np.sqrt(np.mean(band_sig[b] ** 2) + 1e-9)
    # fricative spectrum: Gaussian bump at nc(t); breath: formant envelope
    fric_gain = np.exp(-0.5 * ((centers[None, :] - nc[:, None])
                               / nw[:, None]) ** 2)     # [T, B]
    breath_gain = envelope(centers) * 0.10               # audible breathiness
    noise_ctrl = fric[:, None] * fric_gain * 0.6 + breath_gain
    noise = np.zeros(n_samples)
    for b in range(n_bands):
        noise += np.interp(t_audio, t_ctrl, noise_ctrl[:, b]) * band_sig[b]

    amp_a = np.interp(t_audio, t_ctrl, amp)
    sig = amp_a * (harm + noise)
    return np.asarray(sig, np.float32)


def corpus_dir(data_dir: Path, n: int, profile: str) -> Path:
    """Where ``build_synthetic_corpus`` writes an ``n``-utterance corpus."""
    return Path(data_dir) / (f"synthetic-{n}" if profile == "v1"
                             else f"synthetic-{profile}-{n}")


def build_synthetic_corpus(data_dir: Path, n: int, sample_rate: int = 22050,
                           profile: str = "v2") -> Path:
    """LJSpeech-format corpus whose audio is a deterministic function of
    the text's phoneme sequence, with per-utterance prosody variation.

    Per utterance, from one ``default_rng(42)``: a random sentence of
    4–13 words, phonemized by the port's G2P, a speaking rate and an F0
    shift. v1/v2 render each phoneme's hash-keyed signature for a
    hash-keyed duration (edge fades against clicks); v3 renders the
    content phonemes (edge SILs dropped) at one duration through
    ``_render_utterance_v3`` with a second F0 draw. Each utterance is peak
    normalised to 0.8 and written as 16-bit PCM.
    """
    from m2tts_tpu_torch.frontend.audio import save_wav
    from m2tts_tpu_torch.frontend.text import TextProcessor

    tp = TextProcessor()
    if profile not in PROFILES:
        raise ValueError(f"unknown synthetic profile {profile!r}")
    signal_fn = _phoneme_signal_v2 if profile == "v2" else _phoneme_signal
    corpus = corpus_dir(data_dir, n, profile)
    wavs = corpus / "wavs"
    wavs.mkdir(parents=True, exist_ok=True)

    words = ("the quick brown fox jumps over a lazy dog while printing "
             "moved ahead with speech synthesis research on fast models "
             "and never was there a better time to hear many good new "
             "words spoken out loud for people who test machines").split()
    rng = np.random.default_rng(42)
    rows = []
    fade = np.hanning(256)
    for i in range(n):
        text = " ".join(rng.choice(words, size=int(rng.integers(4, 14))))
        phonemes = tp.text_to_phonemes(text)
        rate = float(rng.uniform(0.8, 1.3))       # speaking rate
        f0_shift = float(rng.uniform(0.7, 1.4))   # "speaker" F0
        if profile == "v3":
            content = [p for p in phonemes if p != "SIL"]
            f0_shift = float(rng.uniform(0.8, 1.3))
            dur_s = 0.10 * rate
            audio = _render_utterance_v3(content, dur_s, sample_rate,
                                         f0_shift, rng)
        else:
            segs = []
            for ph in phonemes:
                h = zlib.crc32(ph.encode())
                dur_s = (0.05 if ph == "SP" else 0.25 if ph == "SIL"
                         else (0.06 + (h % 97) / 97.0 * 0.12)) * rate
                m = max(int(dur_s * sample_rate), 64)
                seg = signal_fn(ph, m, sample_rate, f0_shift)
                k = min(len(fade) // 2, m // 2)  # edge fades avoid clicks
                seg[:k] *= fade[:k]
                seg[-k:] *= fade[-k:]
                segs.append(seg)
            audio = np.concatenate(segs)
        peak = np.abs(audio).max()
        audio = (0.8 * audio / max(peak, 1e-6)).astype(np.float32)
        fid = f"SYN{i:05d}"
        save_wav(audio, wavs / f"{fid}.wav", sample_rate)
        rows.append((fid, text, text))

    with open(corpus / "metadata.csv", "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter="|")
        w.writerows(rows)
    print(f"Synthetic corpus: {n} utterances -> {corpus}")
    return corpus


def download_ljspeech(data_dir: Path, subset_size: Optional[int] = None
                      ) -> Path:
    """``data_dir/LJSpeech-1.1``, verified: kept when it verifies, else
    extracted from ``data_dir/LJSpeech-1.1.tar.bz2`` (fetched from
    ``LJSPEECH_URL`` only when absent; the archive is removed after). A
    failed fetch or a tree that fails verification exits 1. With
    ``subset_size``, returns its first-N subset."""
    data_dir.mkdir(parents=True, exist_ok=True)
    ljspeech_dir = data_dir / LJSPEECH_DIRNAME

    present = ljspeech_dir.exists() and verify_ljspeech(ljspeech_dir)
    if not present:
        archive = data_dir / Path(LJSPEECH_URL).name
        if not archive.exists():
            try:
                download_file(LJSPEECH_URL, archive)
            except Exception as e:
                print(f"Download failed ({e}). On air-gapped machines use "
                      f"--synthetic N to build a local test corpus.")
                sys.exit(1)
        extract_archive(archive, data_dir)
        archive.unlink(missing_ok=True)

    if not verify_ljspeech(ljspeech_dir):
        print("LJSpeech tree failed verification")
        sys.exit(1)

    if subset_size:
        return create_ljspeech_subset(ljspeech_dir, subset_size)
    return ljspeech_dir


def download_vctk_subset(data_dir: Path, num_speakers: int = 10) -> None:
    # Stubbed, as in the reference (scripts/download_data.py:136-140).
    print("VCTK download is not implemented; LJSpeech is the supported corpus.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Download / build TTS training data (PyTorch port)")
    p.add_argument("--dataset", choices=["ljspeech", "vctk"], default="ljspeech")
    p.add_argument("--data-dir", type=str, default="data")
    p.add_argument("--subset-size", "--subset", dest="subset_size",
                   type=int, default=None,
                   help="build a first-N utterance subset of the "
                        "downloaded (or, with --verify-only, verified) tree")
    p.add_argument("--verify-only", action="store_true",
                   help="verify an existing tree; no network access")
    p.add_argument("--synthetic-profile", default="v3", choices=PROFILES,
                   help="synthetic corpus signal profile (v3: formant-"
                        "synthesized speech-like, STOI floor <0.4; v2: "
                        "envelope-diverse; v1: one envelope per phoneme)")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="generate an N-utterance synthetic corpus")
    args = p.parse_args(argv)

    data_dir = Path(args.data_dir)

    if args.synthetic:
        build_synthetic_corpus(data_dir, args.synthetic,
                               profile=args.synthetic_profile)
        return 0
    if args.dataset == "vctk":
        download_vctk_subset(data_dir)
        return 0
    if args.verify_only:
        tree = data_dir / LJSPEECH_DIRNAME
        if not verify_ljspeech(tree):
            return 1
        if args.subset_size:
            create_ljspeech_subset(tree, args.subset_size)
        return 0
    out = download_ljspeech(data_dir, args.subset_size)
    print(f"Dataset ready at {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
