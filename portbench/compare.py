"""How served audio is held to the reference's.

The program rounds each phoneme's duration to whole frames from its own
arithmetic (bfloat16 in the synthesis), so where a phoneme's scaled
duration lies within rounding of a whole number the program and the
float32 reference may give it one frame more or less. Every later frame
is then shifted by that frame: a served frame is compared with the
reference frames up to ``SHIFT`` frames away, and takes the nearest.

A frame's error is the distance of its samples from the reference
frame's, over the reference frame's norm (floored at a tenth of the
utterance's RMS frame norm, so near-silent frames do not blow it up). A
served frame with no reference frame in reach scores ``MISSING``, and so
does every reference frame beyond the served audio's reach: audio cut
short, dropped or padded fails. A phoneme boundary that moved spoils the
frames within the vocoder's reach of it, a few per moved boundary, so an
utterance is judged by quantiles of its frames' errors:

- ``err_typical``: over the compared utterances, the 90th percentile of
  each utterance's median frame error (how far the served audio lies from
  the reference as a rule: a precision step down moves it for nearly every
  utterance, and so does a fault in many of them);
- ``err_worst``: the largest 90th percentile of an utterance's frame errors
  over the utterances longer than one streaming window (``SHORT`` frames):
  one answer spoilt. The shorter ones count in ``err_typical`` only: there
  bfloat16's error grows (the decoder attends over the ~1,000 padding frames
  of the longest bucket) as fp8's does, and the few frames a moved boundary
  spoils are a tenth of the whole, so their worst does not separate the
  program from the control.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

SHIFT = 16
MISSING = 2.0
SHORT = 72  # frames of one streaming window (64-frame chunk, 4-frame halos)


def frame_errors(served: np.ndarray, ref: np.ndarray, hop: int,
                 shift: int = SHIFT) -> np.ndarray:
    """Per-frame errors of ``served`` audio against ``ref`` (both float,
    whole frames of ``hop`` samples)."""
    fs, fr = len(served) // hop, len(ref) // hop
    if fr == 0:
        return np.full(max(fs, 1), MISSING)
    P = served[: fs * hop].reshape(fs, hop).astype(np.float64)
    R = ref[: fr * hop].reshape(fr, hop).astype(np.float64)
    norms = np.sqrt((R * R).sum(1))
    den = np.maximum(norms, 0.1 * np.sqrt(np.mean(norms ** 2)) + 1e-12)
    err = np.full(fs, np.inf)
    for k in range(-shift, shift + 1):
        i0, i1 = max(0, -k), min(fs, fr - k)
        if i1 <= i0:
            continue
        d = np.sqrt(((P[i0:i1] - R[i0 + k:i1 + k]) ** 2).sum(1))
        err[i0:i1] = np.minimum(err[i0:i1], d / den[i0 + k:i1 + k])
    err[~np.isfinite(err)] = MISSING
    extra = max(0, fr - fs - shift)
    return np.concatenate([err, np.full(extra, MISSING)])


def numbers(pairs: Iterable[Tuple[np.ndarray, np.ndarray]], hop: int,
            labels: Iterable = ()) -> Dict:
    """The compared numbers over (served, reference) audio pairs; also
    ``worst`` (the label, served and reference frames and quantiles of the
    utterance that set ``err_worst``) and ``each`` (every utterance's
    frames and 50th, 75th and 90th percentiles)."""
    each, worst = [], None
    labels = iter(labels)
    for served, ref in pairs:
        e = frame_errors(served, ref, hop)
        q = [round(float(x), 5) for x in np.quantile(e, (0.5, 0.75, 0.9))]
        row = {"label": next(labels, len(each)),
               "served_frames": len(served) // hop,
               "ref_frames": len(ref) // hop, "p50": q[0], "p75": q[1],
               "p90": q[2]}
        if row["ref_frames"] > SHORT and (worst is None
                                          or row["p90"] > worst["p90"]):
            worst = row
        each.append(row)
    medians = [r["p50"] for r in each]
    return {"err_typical": float(np.quantile(medians, 0.9))
            if each else MISSING,
            "err_worst": worst["p90"] if worst else MISSING,
            "compared": len(each), "worst": worst,
            "each": [[r["served_frames"], r["p50"], r["p75"], r["p90"]]
                     for r in each]}


def checks(nums: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: {value, limit}}): each number the cell's limits file
    names (every key but ``min_compared``, in the file's order) at or under
    its limit, and at least ``min_compared`` answers (utterances, or a
    training cell's steps) compared. A cell leaves out a number that does
    not separate its program's readings from its control's."""
    names = [k for k in limits if k != "min_compared"]
    out = {k: {"value": nums[k], "limit": limits[k]} for k in names}
    out["compared"] = {"value": nums["compared"],
                       "limit": limits["min_compared"]}
    ok = (all(nums[k] <= limits[k] for k in names)
          and nums["compared"] >= limits["min_compared"])
    return ok, out
