"""The stage-2 GAN cell on the CPU at tiny widths (the discriminator at its
own): the plain reference against the port's step on the same seeded
state, batch and seeds; a run of the cell's driver comes out correct, and
each planted fault reads ``correct: false`` under the cell's limits; the
step's FLOP count."""

import json

import pytest
import torch

from portbench import train_compare as tc
from portbench.harness import find_cell, load_json, manifest
from portbench.reference import gan
from portbench.reference import model as ref
from portbench.run import Context, run_cell
from portbench.train_faults import FAULTS
from portbench.weights import make_disc_state_dict, make_state_dict

MAN = manifest()
SEED = 2 ** 34 + 19
CELL = "xl.gan-train"


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    from m2tts_tpu_torch.data.download_data import build_synthetic_corpus

    root = tmp_path_factory.mktemp("gan_corpus")
    build_synthetic_corpus(root, 8, profile="v3")
    return root


def _mix(root, tmp_path):
    """The cell's mix at a tiny size: 8 utterances, batch 2, 2048-sample
    windows in float32 (the CPU's bf16 convolutions are not the card's),
    and an lr that moves the weights well past rounding within a few
    steps."""
    mix = load_json("traffic", "gan-quality-xl")
    return dict(mix, corpus=dict(mix["corpus"], utterances=8, root=str(root)),
                run_root=str(tmp_path / "run"),
                training=dict(mix["training"], batch_size=2, bf16=False,
                              audio_segment_len=2048, learning_rate=1e-3,
                              warmup_steps=2),
                data=dict(mix["data"], buckets=[[64, 256], [128, 512]]))


def test_reference_equals_the_program_step(tiny, corpus_root, tmp_path):
    """Two steps of the port's trainer and of the reference from the same
    weights, on the same batches and seeds: every loss term, both nets'
    gradients as the optimizers got them, and the weights and EMA after."""
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    from portbench.drivers import gan_train

    mix = _mix(corpus_root, tmp_path)
    ctx = Context(find_cell(MAN, CELL), SEED, 1.0, False, device="cpu",
                  config=tiny, mix=mix)
    t = Stage2Trainer(gan_train.trainer_config(ctx, gan_train.corpus(mix)),
                      device="cpu")
    g0 = make_state_dict(tiny["model"], SEED, "cpu")
    d0 = make_disc_state_dict(SEED, "cpu")
    gan_train.load_weights(t, g0, d0)
    it = t._device_cached_iterator()
    s = ref.Sizes(tiny["model"])
    r = gan.Recipe(mix["training"], s.upsample, 22050, 80)
    st = gan.State.start(g0, d0, ema=True)
    side = gan_train.Side(t)
    for _ in range(2):
        batch = next(it)
        before = side.snapshot()
        seeds = t._noise_seed(t.step, 0), t._noise_seed(t.step, 1)
        got = {k: float(v) for k, v in t.train_step(batch).items()}
        st, want, grads = gan.step(st, s, r, batch, *seeds)
        assert set(got) == set(want)
        for name, v in want.items():
            assert got[name] == pytest.approx(v, rel=1e-5, abs=1e-7), name
        mu = side.moments()
        for net in ("g", "d"):
            for name, g in grads[net].items():
                prog = (mu[net][0][name] - r.b1 * before[f"{net}_m"].get(
                    name, torch.zeros_like(g))) / (1 - r.b1)
                assert float((prog - g).norm()) <= 1e-3 * float(
                    g.norm()) + 1e-9, (net, name)
    # the weights after: to a thousandth of the step's change, past the
    # float32 rounding of the weights themselves (the EMA's change is a
    # few units in the last place)
    w = side.weights()
    for net, want in (("g", st.g), ("d", st.d), ("ema", st.ema)):
        moved = tc.diff_norms(want, before[net])
        for name, p in want.items():
            assert float((w[net][name].detach() - p).norm()) <= (
                1e-3 * moved[name] + 1e-6 * float(p.norm())), (net, name)


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_a_broken_step_is_not_correct(tiny, corpus_root, tmp_path, fault):
    limits = load_json("limits", CELL)
    ctx = Context(find_cell(MAN, CELL), SEED, 1.0, False, device="cpu",
                  config=tiny, mix=_mix(corpus_root, tmp_path),
                  limits=limits, inject=FAULTS.get(fault))
    result = run_cell(MAN, ctx)
    json.dumps(result)
    assert list(result)[-1] == "checks"
    assert result["checks"]["compared"]["value"] == limits["min_compared"]
    assert result["correct"] is (fault is None), result["checks"]
    assert result["metrics"]["gan_step_ms"]["value"] > 0


def test_the_control_fails_the_limits(tiny, corpus_root, tmp_path):
    """The reference in fp8 in the program's place (``Context.control``)
    reads past the cell's limits."""
    from portbench import compare

    limits = load_json("limits", CELL)
    ctx = Context(find_cell(MAN, CELL), SEED, 1.0, False, device="cpu",
                  config=tiny, mix=_mix(corpus_root, tmp_path), limits=limits)
    ctx.control = "fp8"
    run_cell(MAN, ctx)
    correct, checks = compare.checks(ctx.control_numbers, limits)
    assert correct is False, checks


def test_step_flops_count_the_passes(tiny):
    from portbench.work import GanStepFlops

    mix = load_json("traffic", "gan-quality-xl")
    c = GanStepFlops(tiny["model"], mix["training"])
    small, big = c.step(64, 256), c.step(256, 1000)
    assert 0 < small < big
    assert c.step(64, 256) == small  # counted once a bucket
    # the discriminator's share alone: 3 scales of 6 convs on 32 rows of
    # 32768 samples, forward and backward, is past a TFLOP
    assert small > 1e12


def test_numbers_read_the_leaves():
    t = torch.tensor
    ref_g = {"w": t([1.0]), "v": t([1.0]), "u": t([1.0]), "tiny": t([1e-6])}
    prog_g = {"w": t([1.1]), "v": t([-0.8]), "u": t([1.0]),
              "tiny": t([0.5])}
    norms = tc.leaf_norms(ref_g)
    ref_rec = [{"losses": {"a": 2.0, "b": 1.0},
                "grad_tensors": {"g": ref_g, "d": ref_g},
                "grad": {"g": norms, "d": norms},
                "change": {"g": {"w": 1.0, "v": 1.0, "tiny": 1e-6}},
                "grad_for_change": {"g": {"w": 1.0, "v": 1.0,
                                          "tiny": 1e-9}}}]
    prog = [{"losses": {"a": 2.2}, "grad_tensors": {"g": prog_g, "d": prog_g},
             "grad": {"g": tc.leaf_norms(prog_g), "d": tc.leaf_norms(prog_g)},
             "change": {"g": {"w": 1.0, "v": 0.5, "tiny": 1.0}}}]
    n = tc.numbers(prog, ref_rec)
    assert n["loss_rel_err"] == pytest.approx(1.0)  # "b" missing reads 0
    # differences of 0.1, 1.8, 0 and 0.5, each over the larger of its
    # leaf's norm and the median leaf's: the generator's number takes the
    # worst leaf, the discriminator's the median leaf
    assert n["grad_rel_err.g"] == pytest.approx(1.8, rel=1e-5)
    assert n["grad_rel_err.d"] == pytest.approx(0.3, rel=1e-5)
    # gaps of norms, shown: 0.1, 0.2, 0 and 0.5; a sign reads none
    median, worst, where = n["readings"]["first.gap.g"]
    assert (median, worst) == pytest.approx((0.15, 0.5), rel=1e-5)
    assert where == "step 0: tiny"
    # the tiny leaf's reference gradient is nought: its change is left out
    assert n["update_rel_err"] == pytest.approx(0.5)
    assert n["compared"] == 1
    assert n["loss_past_rel_err"] == n["update_past_rel_err"] == 0.0
    # the step past the window: its losses by the median term (0 and
    # 0.05), its gradient and its change by the median leaf; the first
    # step's numbers stay
    ref_past = {"losses": {"a": 2.0, "b": 1.0}, "grad_tensors": {"g": ref_g},
                "grad": {"g": norms}, "past": True,
                "change": {"g": {"w": 1.0, "v": 1.0, "u": 1.0}},
                "grad_for_change": {"g": {"w": 1.0, "v": 1.0, "u": 1.0}}}
    prog_past = {"losses": {"a": 2.0, "b": 1.05},
                 "grad_tensors": {"g": prog_g},
                 "change": {"g": {"w": 1.0, "v": 0.5, "u": 0.9}}}
    m = tc.numbers(prog + [prog_past], ref_rec + [ref_past])
    assert m["loss_past_rel_err"] == pytest.approx(0.025, rel=1e-5)
    assert m["grad_past_rel_err.g"] == pytest.approx(0.3, rel=1e-5)
    assert m["grad_past_rel_err.d"] == 0.0  # none in these records
    assert m["update_past_rel_err"] == pytest.approx(0.1)
    for k in ("loss_rel_err", "grad_rel_err.g", "update_rel_err"):
        assert m[k] == n[k], k
    assert m["compared"] == 2
    assert set(tc.NAMES) <= set(m)


def test_kernel_classes_pinned_on_a_recorded_step():
    """The names the profiler gave one H100's GAN steps: the convolution
    and optimizer patterns take exactly the operations recorded in each
    class (cuDNN's and its CUTLASS kernels, the layout transposes; the
    foreach kernels), and leave the GEMMs and elementwise work."""
    from portbench.drivers.gan_train import CONV_RE, OPTIMIZER_RE
    from portbench.harness import HERE

    ops = json.loads((HERE / "tests" / "gan_device_ops.json").read_text())[
        "ops"]
    for name, cls, _, _ in ops:
        got = ("conv" if CONV_RE.search(name) else
               "optimizer" if OPTIMIZER_RE.search(name) else "other")
        assert got == cls, name
    by = {c: sum(ms for _, k, ms, _ in ops if k == c)
          for c in ("conv", "optimizer", "other")}
    assert by["conv"] > by["other"] > by["optimizer"] > 0


def test_a_traced_run_reads_its_layers(tiny, corpus_root, tmp_path):
    """With ``--trace 1`` the profiler covers the window's last
    ``TRACE_SECONDS``, at most its second half; the run reports the cell's
    per-layer metrics that the CPU has (no device kernels: the convolution
    and optimizer times read nothing)."""
    mix = _mix(corpus_root, tmp_path)
    ctx = Context(find_cell(MAN, CELL), SEED, 2.0, True, device="cpu",
                  config=tiny, mix=mix, limits=load_json("limits", CELL))
    result = run_cell(MAN, ctx)
    assert result["correct"] is True
    assert 0 < result["metrics"]["mfu.train"]["value"] < 100
    assert "conv_ms.train" not in result["metrics"]
    assert 0 < ctx.last_record["steps"] <= result["attempted"]
    assert result["device"]["window_s"] < 2.0
