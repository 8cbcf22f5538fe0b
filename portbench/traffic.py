"""The one traffic generator: reads a mix's parameters, makes its texts,
sizes and arrival times from the seed.

Every seed gets the same multiset of sizes and of gaps between arrivals
(quantiles of the mix's distributions at evenly spaced probabilities) in
another order, and other words, so two seeds ask for the same work.

A mix file (``traffic/<mix>.json``) holds:

- ``loop``: ``closed`` (one client, back-to-back calls of ``batch`` texts
  from a pool of ``pool`` texts in pool order) or ``open`` (arrivals at
  ``rate_per_s``, Poisson: exponential gaps);
- ``phonemes`` or ``audio_s``: the length distribution of a text, in
  phonemes or in seconds of audio (``normal`` or ``lognormal`` with
  ``mean``/``sd`` or ``median``/``sigma``, cut to ``min``..``max``);
- ``phonemes_per_s``: the speaking rate the duration scale is calibrated
  to, so a text of n phonemes lasts about n / rate seconds;
- ``sample``: how many served requests the check compares (besides the
  longest and the shortest).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

from portbench.reference.text import TextProcessor

HERE = Path(__file__).resolve().parent
WORDS = HERE / "words.txt"


def load_mix(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """n values of the distribution ``spec`` at probabilities (i + ½)/n of
    its part between ``min`` and ``max``."""
    unit = NormalDist()
    if spec["dist"] == "normal":
        mu, sd = float(spec["mean"]), float(spec["sd"])

        def to_z(v):
            return (v - mu) / sd

        def from_z(z):
            return mu + sd * z
    elif spec["dist"] == "lognormal":
        mu, sd = math.log(float(spec["median"])), float(spec["sigma"])

        def to_z(v):
            return (math.log(v) - mu) / sd

        def from_z(z):
            return math.exp(mu + sd * z)
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    lo, hi = unit.cdf(to_z(spec["min"])), unit.cdf(to_z(spec["max"]))
    p = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return np.array([from_z(unit.inv_cdf(float(x))) for x in p])


def target_phonemes(mix: Dict, n: int) -> np.ndarray:
    """The sorted multiset of n text lengths, in phonemes."""
    if "phonemes" in mix:
        v = quantiles(mix["phonemes"], n)
    else:
        v = quantiles(mix["audio_s"], n) * float(mix["phonemes_per_s"])
    return np.maximum(np.rint(v).astype(int), 3)


class TextMaker:
    """Sentences of a given phoneme count, made of the word list's words."""

    def __init__(self):
        self.tp = TextProcessor()
        self.words = WORDS.read_text().split()
        # a word's phonemes, the SP after it included
        self.cost = np.array([len(self.tp.text_to_phonemes(w)) - 2 + 1
                              for w in self.words])

    def sentence(self, target: int, rng: np.random.Generator) -> str:
        """Words drawn until the sentence (SIL wrap included) reaches
        ``target`` phonemes; the last word stays only where that ends
        nearer the target."""
        n, out = 1, []  # the SIL wrap less the last word's SP
        while n < target:
            i = int(rng.integers(len(self.words)))
            if out and n + self.cost[i] - target > target - n:
                break
            out.append(self.words[i])
            n += int(self.cost[i])
        out[0] = out[0].capitalize()
        return " ".join(out) + "."

    def texts(self, targets: Sequence[int], rng: np.random.Generator
              ) -> List[str]:
        return [self.sentence(int(t), rng) for t in targets]


def shuffled(values: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return values[rng.permutation(len(values))]


def arranged(mix: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The mix's n text lengths in the order they are sent. A mix of
    ``batch``-text calls gives every call one length from each of ``batch``
    strata of the sorted lengths (which one, and the order inside the call,
    from the seed), so every call, in every seed, asks for nearly the same
    work: the longest stratum sets each call's frame bucket. Otherwise (or
    where n is not a whole number of calls) the lengths are shuffled."""
    sizes = np.sort(target_phonemes(mix, n))
    if "batch" not in mix or n % int(mix["batch"]):
        return shuffled(sizes, rng)
    B = int(mix["batch"])
    strata = sizes.reshape(B, n // B)
    strata = np.stack([shuffled(row, rng) for row in strata], axis=1)
    return np.concatenate([shuffled(call, rng) for call in strata])


def arrivals(rate_per_s: float, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """Send times in [0, seconds): ``round(rate · seconds)`` Poisson
    arrivals, their gaps the exponential quantiles in the seed's order,
    scaled to end at ``seconds``."""
    n = max(1, int(round(rate_per_s * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = shuffled(gaps, rng)
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return times * (seconds / gaps.sum())


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, all from the run's seed."""
    tag = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([int(seed) % (2 ** 64), tag])
