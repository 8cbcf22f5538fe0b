"""The plain reference against the port's CPU path at a tiny size: the
benchmark's weights load into the port by name, and the port's batch and
streaming outputs equal the reference's to float32 rounding."""

import numpy as np
import pytest
import torch

from portbench import compare
from portbench.cellkit import Cell, bucket_for
from portbench.harness import load_json
from portbench.reference import model as ref
from portbench.weights import make_state_dict


def _cell(tiny, mix_name, n, seed=2 ** 33 + 5):
    mix = load_json("traffic", mix_name)
    return Cell(tiny, mix, seed, "cpu", n)


def test_weights_are_the_init_rule(tiny):
    sd = make_state_dict(tiny["model"], 7, "cpu")
    # biases and LayerNorm affines are drawn about 0 and 1, never left at
    # them, so a kernel that drops one shows
    for name, centre in (("text_encoder.layer0.norm1.weight", 1.0),
                         ("text_encoder.layer0.norm1.bias", 0.0),
                         ("decoder.layer0.ffn.fc1.bias", 0.0),
                         ("vocoder.upsample0.bias", 0.0)):
        x = sd[name] - centre
        assert x.abs().min() > 0 and 0.02 < x.std().item() < 0.3, name
    w = sd["decoder.layer0.ffn.fc1.weight"]  # xavier-uniform [32, 16]
    assert w.abs().max() <= (6 / 48) ** 0.5
    e = sd["text_encoder.embedding.weight"]
    assert abs(e.std().item() - 1) < 0.05
    t = sd["vocoder.upsample0.weight"]  # truncated at 2 sigma
    std = (1 / (t.shape[0] * t.shape[1])) ** 0.5 / 0.8796
    assert t.abs().max() <= 2 * std + 1e-6
    assert torch.equal(make_state_dict(tiny["model"], 7, "cpu")[
        "vocoder.upsample0.weight"], t)


def test_batch_path_equals_the_reference(tiny):
    cell = _cell(tiny, "bulk-narration", 8)
    synth = cell.build_synthesizer()  # loads the dict by name, strictly
    call = cell.texts[:8]
    got = synth.synthesize_batch(call, cell.scale)
    served = bucket_for(max(r["frames"] for r in got),
                        cell.serving["frame_buckets"])
    want = cell.batch_audio(call, list(range(8)), served)
    for g, w in zip(got, want):
        assert len(g["audio_pcm"]) == len(w)
        d = np.abs(g["audio_pcm"].astype(np.float32) / 32767.0 - w)
        assert d.max() <= 2 / 32767.0
    # and the per-frame comparison reads rounding only
    nums = compare.numbers([(g["audio_pcm"] / 32767.0, w)
                            for g, w in zip(got, want)], cell.hop)
    assert nums["err_worst"] < 1e-3


def test_stream_path_equals_the_reference(tiny):
    from portbench.drivers.stream import build

    cell = _cell(tiny, "interactive-stream", 6)
    _, ss, sb = build(cell)
    try:
        for text in cell.texts[:6]:
            got = np.concatenate(list(sb.stream(text, cell.scale, timeout=60)))
            want = cell.stream_audio(text, ss.vocoder._window)
            assert got.shape == want.shape
            assert np.abs(got - want).max() < 1e-4
    finally:
        sb.close()


def test_calibration_hits_the_speaking_rate(tiny):
    cell = _cell(tiny, "bulk-narration", 64)
    seconds = cell.totals.sum() * cell.hop / cell.sr
    want = cell.phonemes.sum() / cell.mix["phonemes_per_s"]
    assert seconds == pytest.approx(want, rel=0.01)
    # the totals are the float32 reference's probe at that scale
    ids, lengths = cell.encode(cell.texts[:4])
    t = ref.totals(cell.sd, cell.sizes, ids, lengths, cell.scale)
    assert t.tolist() == cell.totals[:4].tolist()
