"""The frozen work counts against hand counts, and the model's FLOPs."""

import math

import pytest
import torch

from portbench import work


def test_stage_and_vocoder_work_by_hand():
    # flagship vocoder, one stage: B=2, T=10, mel 80, 256 channels, rates
    # (8, 8, 2, 2), stage 0 in bf16
    B, T, c, co, r = 2, 10, 256, 128, 8
    flops, nbytes = work.stage_work(B, T, 80, 256, (8, 8, 2, 2), 0, 2)
    tconv = 2 * 2 * c * co * r * T          # 2 live taps of 2r per output
    res = 2 * (2 * 3 * co * co) * r * T     # two k=3 convs at T·r
    conv_in = 2 * 3 * 80 * c * T
    assert flops == B * (tconv + res + conv_in)
    weights = 3 * c * r * co + 2 * 3 * co * co + 3 * 80 * c
    assert nbytes == B * T * 80 * 4 + B * T * r * co * 2 + weights * 2
    total, _ = work.vocoder_work(B, T, 80, 256, (8, 8, 2, 2), 2)
    assert total == sum(work.stage_work(B, T, 80, 256, (8, 8, 2, 2), i, 2)[0]
                        for i in range(4))
    ms, what = work.bound(989e12, 0, "bf16")
    assert ms == pytest.approx(1e3) and what == "operations"
    ms, what = work.bound(0, 3.35e12, "f32")
    assert ms == pytest.approx(1e3) and what == "bytes"
    # the flagship's 32 x 1024 call: 0.39 TFLOP at bf16, with the zero
    # taps skipped
    f, _ = work.vocoder_work(32, 1024, 80, 256, (8, 8, 2, 2), 2)
    assert 0.38e12 < f < 0.40e12
    f, _ = work.vocoder_work(32, 1024, 80, 512, (8, 8, 2, 2), 2)
    assert 1.5e12 < f < 1.6e12


def test_launch_bound_sums_the_stages():
    want = sum(work.bound(*work.stage_work(8, 72, 80, 256, (8, 8, 2, 2), i,
                                           2), "bf16")[0] for i in range(4))
    assert work.launch_bound_ms(8, 72, 80, 256, (8, 8, 2, 2),
                                "bf16") == pytest.approx(want)


def test_model_flops_is_the_counter_at_any_length(tiny):
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import model as ref

    counter = work.ModelFlops(tiny["model"])
    s = ref.Sizes(tiny["model"])
    sd = {n: torch.empty(shape, device="meta")
          for n, shape, _ in ref.param_spec(s)}
    S, F = 77, 301
    with FlopCounterMode(display=False) as fc:
        enc, _ = ref.encode(sd, s, torch.zeros((1, S), dtype=torch.long,
                                               device="meta"),
                            torch.full((1,), S, device="meta"))
        ref.durations(sd, enc)
        ref.vocode(sd, s, ref.decode(sd, s, torch.empty((1, F, s.hidden),
                                                        device="meta")))
    assert counter.utterance(S, F) == pytest.approx(fc.get_total_flops(),
                                                    rel=1e-9)
    assert math.isfinite(counter.utterance(15, 1024))
