"""Helpers shared by the Synthesizer's CPU and card tests: a launch's
results by the host formulas (a plain fetch of its outputs, numpy trims,
``mulaw_decode_np`` and ``astype(np.float32) / 32767.0``), and a byte for
byte comparison of two result lists."""

import numpy as np

from m2tts_tpu_torch.ops.audio_codec import mulaw_decode_np


def host_formulas(synth, out, max_frames, n, want_mel, pcm_only):
    """``synth``'s launch outputs ``out`` as per-utterance results, made
    on the host from a plain copy of the outputs."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    pcm, totals = host["pcm"], host["total_frames"]
    results = []
    for i in range(n):
        frames = int(min(totals[i], max_frames))
        trimmed = pcm[i, : frames * synth.upsample]
        if pcm.dtype == np.uint8:
            res = {"audio_mulaw": trimmed, "frames": frames}
            if not pcm_only:
                trimmed = mulaw_decode_np(trimmed)
                res["audio_pcm"] = trimmed
        else:
            res = {"audio_pcm": trimmed, "frames": frames}
        if int(totals[i]) > max_frames:
            res["truncated"] = True
        if not pcm_only:
            res["audio"] = trimmed.astype(np.float32) / 32767.0
        if want_mel:
            res["mel"] = host["mel"][i, :frames]
        results.append(res)
    return results


def same_results(got, want):
    """Byte for byte: the same keys, dtypes, shapes and bytes."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert (g[k].dtype, g[k].shape) == (v.dtype, v.shape), k
                assert g[k].tobytes() == v.tobytes(), k
            else:
                assert g[k] == v, k
