"""Stage-2 GAN training: one job, GAN steps back to back, as the trainer's
own ``train()`` loop runs them: its device-cached iterator, each step
through ``_guarded_step`` (the out-of-memory guard), and at every
``log_every``-th step the one host read of the losses with the blow-up
check; the thermal guard and the step profiler as the loop has them.
Validation and checkpoint saves stay out: the recipe runs neither within a
window.

The mix names the corpus (the port's synthetic corpus, built once per
checkout under ``build/portbench-data``), the recipe's ``training``,
``data`` and ``system`` sections as the configuration file has them, and
the driver; the configuration names the model. The run's seed sets both
nets' weights (``weights.py``) and the trainer's ``seed`` (batch
composition, epoch order, windows and dropout). A bucket's first step runs
eagerly and captures its CUDA graph; set-up runs steps until every bucket
of the corpus has been captured, so the window replays graphs only.

End to end: ``gan_step_ms``, the window's seconds over the GAN steps
completed in it. Traced (``--trace 1``): the profiler runs over the last
``TRACE_SECONDS`` of the window, at most its second half (a step makes
some 17,000 device operations, and reading a whole window's trace would
outlast a run's time), and the traced stretch gives the FLOPs of its steps
(``work.GanStepFlops`` by bucket) over its length, its device time in
convolutions and the layout transposes around them and in the
optimizers' foreach kernels, and the device's busy time.

The check (``train_compare``): the plain float32 reference
(``reference/gan.py``) follows the run's first three steps from the
seed's weights, on the same batches with the same dropout and window
seeds, and one more step after the window, a replay of its bucket's
graph, from the program's own state; both after the window has closed
and the program is freed. Each step is read by its losses; the first
and the last by the gradients the optimizers got (read from Adam's first
moments: after an update ``mu = b1 · mu_before + (1 − b1) · g``); the
third by the norms of the weights' change since the seed's, and the last
by the norms of the weights' and the EMA's change in it. The cell's
limits name the numbers compared (``train_compare.NUMBERS``).
"""

from __future__ import annotations

import math
import re
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from portbench import train_compare as tc
from portbench.cellkit import free_device
from portbench.harness import ROOT, forbidden_modules, say
from portbench.reference import gan
from portbench.reference import model as ref
from portbench.trace import Window, span
from portbench.weights import make_disc_state_dict, make_state_dict

#: convolution kernels and the layout transposes around them, by the names
#: the profiler gives cuDNN's and cuBLAS's kernels (pinned by a test on a
#: recorded list of a step's device operations)
CONV_RE = re.compile(
    r"conv|xmma|implicit_gemm|dgrad|wgrad|fprop|nchwToNhwc|nhwcToNchw"
    r"|cudnn|Winograd|winograd", re.I)
#: the optimizers' foreach kernels: the global norms, the clip, AdamW, the
#: discriminator's update guard and the EMA
OPTIMIZER_RE = re.compile(r"multi_tensor_apply|lpnorm_cleanup")
DATA_ROOT = ROOT / "build" / "portbench-data"
RUN_ROOT = ROOT / "build" / "portbench-gan"
FIRST = 3  # the steps from the seed the reference follows
#: the window's last seconds the traced run profiles (at most its half)
TRACE_SECONDS = 10.0


def corpus(mix: Dict) -> Path:
    """The mix's corpus, built by the port's corpus builder the first time
    a checkout asks for it (the builder writes ``metadata.csv`` last)."""
    from m2tts_tpu_torch.data.download_data import (build_synthetic_corpus,
                                                    corpus_dir)

    c = mix["corpus"]
    root = Path(c.get("root", DATA_ROOT))
    path = corpus_dir(root, int(c["utterances"]), c["profile"])
    if not (path / "metadata.csv").exists():
        build_synthetic_corpus(root, int(c["utterances"]),
                               profile=c["profile"])
    return path


def trainer_config(ctx, data_dir: Path):
    from m2tts_tpu_torch.utils.config import Config

    mix = ctx.mix
    out = Path(mix.get("run_root", RUN_ROOT))
    return Config({
        "model": ctx.config["model"],
        "training": dict(mix["training"], seed=ctx.seed % (2 ** 32)),
        "data": dict(mix["data"], data_dir=str(data_dir)),
        "system": mix.get("system", {}),
        "paths": {"output_dir": str(out), "checkpoint_dir": str(out / "ckpt"),
                  "log_dir": str(out / "logs")}})


@torch.no_grad()
def load_weights(trainer, g: Dict[str, torch.Tensor],
                 d: Dict[str, torch.Tensor]) -> None:
    """The seed's weights into both nets (in place, so the optimizers
    hold them), the EMA from them, and the rewind snapshot taken anew."""
    trainer.model.load_state_dict(g)
    trainer.discriminator.load_state_dict(d)
    if trainer.ema is not None:
        for e, p in zip(trainer.ema, trainer.g_params):
            e.copy_(p)
    trainer._oom_snapshot = trainer._snapshot()


def buckets_of(trainer) -> set:
    """The (text, frames) buckets the corpus fills."""
    from m2tts_tpu_torch.data.dataset import select_bucket

    ds = trainer.dataset
    return {select_bucket(len(s["phoneme_ids"]), int(s["mel_length"]),
                          trainer.buckets)
            for s in (ds[i] for i in range(len(ds)))}


class Side:
    """What the check reads of the program: its weights, moments and EMA
    by name, and the records of the compared steps."""

    def __init__(self, trainer):
        self.t = trainer
        self.b1 = float(trainer.g_opt.adamw.param_groups[0]["betas"][0])

    def weights(self) -> Dict[str, Dict[str, torch.Tensor]]:
        t = self.t
        out = {"g": dict(zip(t.g_names, t.g_params)),
               "d": dict(zip(t.d_names, t.d_params))}
        if t.ema is not None:
            out["ema"] = dict(zip(t.g_names, t.ema))
        return out

    def moments(self) -> Dict[str, Tuple[Dict, Dict]]:
        out = {}
        for net, opt in (("g", self.t.g_opt), ("d", self.t.d_opt)):
            st = opt.state_dict()
            out[net] = (st["mu"], st["nu"])
        return out

    @torch.no_grad()
    def grads(self, before: Optional[Dict] = None
              ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each net's gradient of the last update as its optimizer got it,
        from its first moment after the update and ``before`` it (a
        ``snapshot``; none: the first update, from zeros):
        ``(mu − b1 · mu_before) / (1 − b1)``."""
        b1 = self.b1
        out = {}
        for net, (mu, _) in self.moments().items():
            prev = before[f"{net}_m"] if before is not None else {}
            out[net] = {k: (v - b1 * prev[k] if k in prev else v) / (1 - b1)
                        for k, v in mu.items()}
        return out

    @torch.no_grad()
    def snapshot(self) -> Dict:
        """Device copies of both nets, both optimizers' moments, the EMA,
        and the counts a step reads."""
        t = self.t
        clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
        w = self.weights()
        m = self.moments()
        return {"g": clone(w["g"]), "d": clone(w["d"]),
                "ema": clone(w["ema"]) if "ema" in w else None,
                "g_m": clone(m["g"][0]), "g_v": clone(m["g"][1]),
                "d_m": clone(m["d"][0]), "d_v": clone(m["d"][1]),
                "g_count": t.g_opt.count, "d_count": t.d_opt.count,
                "g_updates": t.g_updates}


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return dict(zip(metrics, torch.stack([v.float() for v in
                                          metrics.values()]).tolist()))


def _bucket(batch) -> Tuple[int, int]:
    return int(batch["phoneme_ids"].shape[1]), int(batch["mel"].shape[1])


def run(ctx) -> Dict:
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    mix, seed, dev = ctx.mix, ctx.seed, ctx.device
    data_dir = corpus(mix)
    ctx.mark("corpus")
    model = ctx.config["model"]
    spectral = bool(mix["training"]["discriminator_spectral_norm"])
    g0 = make_state_dict(model, seed, dev)
    d0 = make_disc_state_dict(seed, dev, spectral)
    ctx.mark("weights")
    trainer = Stage2Trainer(trainer_config(ctx, data_dir), device=dev)
    load_weights(trainer, g0, d0)
    ctx.inject(trainer)
    ctx.mark("trainer_and_corpus_ingest")
    it = trainer._device_cached_iterator()
    if it is None:
        raise RuntimeError("the corpus does not fit the device data cache")
    want = buckets_of(trainer)
    ctx.mark("stage_on_device")

    side = Side(trainer)
    prog: List[Dict] = []
    inputs: List[Tuple] = []  # (batch, dropout seed, offsets seed)
    seen = set()
    while len(prog) < FIRST or seen != want:
        batch = next(it)
        seeds = (trainer._noise_seed(trainer.step, 0),
                 trainer._noise_seed(trainer.step, 1))
        metrics = trainer._guarded_step(batch)
        if metrics is None:
            raise RuntimeError("out of memory in set-up's steps")
        seen.add(_bucket(batch))
        if len(prog) < FIRST:
            rec = {"losses": _host(metrics)}
            if not prog:
                rec["grad_tensors"] = side.grads()
                rec["grad"] = {n: tc.leaf_norms(g) for n, g in
                               rec["grad_tensors"].items()}
            if len(prog) == FIRST - 1:
                w = side.weights()
                rec["change"] = {"g": tc.diff_norms(w["g"], g0),
                                 "d": tc.diff_norms(w["d"], d0)}
            prog.append(rec)
            inputs.append((batch, *seeds))
    ctx.mark("first_steps_and_capture")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded at the end of set-up: {found}")
    graphs0 = trainer._graphs.stats()["graphs"] if trainer._graphs else 0
    say(f"set-up: {trainer.step} steps, buckets {sorted(want)}, {graphs0} "
        f"graphs, seed {trainer.seed}")

    trace = ctx.trace
    attempts, steps, failed, by_bucket = 0, 0, 0, Counter()
    traced, in_trace = None, Counter()
    tail = min(TRACE_SECONDS, ctx.seconds / 2)
    log_every = trainer.log_every
    ctx.setup_done()
    with Window(dev, False) as win:
        # traced: at least one step, where the window ends sooner than it
        while (time.perf_counter() - win.t0 < ctx.seconds
               or (trace and traced is None)):
            if (trace and traced is None
                    and time.perf_counter() - win.t0 >= ctx.seconds - tail):
                traced = Window(dev, True).__enter__()
            if not trainer.thermal.check():
                trainer.thermal.wait_for_cooldown()
            batch = next(it)
            attempts += 1
            on = traced is not None
            with span("step", on), trainer.profiler.step(trainer.step):
                metrics = trainer._guarded_step(batch)
            if metrics is None:
                failed += 1
                continue
            steps += 1
            by_bucket[_bucket(batch)] += 1
            if on:
                in_trace[_bucket(batch)] += 1
            if trainer.step % log_every == 0:
                with span("log_fetch", on):
                    values = _host(metrics)
                if not all(math.isfinite(v) for v in values.values()):
                    failed += trainer.step - trainer._oom_snapshot[1]
                    trainer._recover_after_blowup()
        if traced is not None:
            traced.close()
        win.close()
    graphs1 = trainer._graphs.stats()["graphs"] if trainer._graphs else 0
    if graphs1 != graphs0:
        say(f"WARNING: {graphs1 - graphs0} graphs captured inside the window")
    peak = ctx.memory_peak()
    say(f"window: {steps} steps ({dict(by_bucket)}), {failed} failed, in "
        f"{win.wall_s:.3f} s; traced: {sum(in_trace.values())} steps in "
        f"{traced.wall_s if traced else 0.0:.3f} s")
    record = {"steps": steps}
    if traced is not None:
        from portbench.work import GanStepFlops

        record.update(traced.record())
        record["steps"] = sum(in_trace.values())
        record["conv_device_s"] = traced.device_s(CONV_RE)
        record["optimizer_device_s"] = traced.device_s(OPTIMIZER_RE)
        counter = GanStepFlops(model, mix["training"])
        record["model_flops"] = sum(counter.step(*b) * n
                                    for b, n in in_trace.items())

    # -- one more step after the window, a replay, from the program's state --
    look = getattr(ctx, "look", None)
    if look is not None:
        look.before(trainer, it)
    before = side.snapshot()
    batch = next(it)
    seeds = (trainer._noise_seed(trainer.step, 0),
             trainer._noise_seed(trainer.step, 1))
    metrics = trainer._guarded_step(batch)
    if metrics is None:
        raise RuntimeError("out of memory in the step after the window")
    w = side.weights()
    grads = side.grads(before)
    last = {"losses": _host(metrics), "grad_tensors": grads,
            "grad": {n: tc.leaf_norms(g) for n, g in grads.items()},
            "change": {net: tc.diff_norms(w[net], before[net])
                       for net in w if before.get(net) is not None}}
    prog.append(last)
    inputs.append((batch, *seeds))
    if look is not None:
        look.after(trainer, side, before, inputs[-1], last)
    del trainer, it, side, w, metrics, grads
    free_device(dev)

    nums, control = check(ctx, g0, d0, inputs, before, prog,
                          getattr(ctx, "control", None))
    ctx.numbers = nums  # every reading, compared or not
    if control is not None:
        ctx.control_numbers = control
    return {"attempted": attempts, "failed": failed,
            "metrics": {"gan_step_ms": 1e3 * win.wall_s / max(steps, 1)},
            "numbers": nums, "record": record, "window": traced or win,
            "memory_peak_bytes": peak}


def recipe(ctx) -> Tuple[ref.Sizes, gan.Recipe, bool]:
    """(the model's sizes, the step's recipe, whether the discriminator is
    spectral-normed) of the cell."""
    s = ref.Sizes(ctx.config["model"])
    t = ctx.mix["training"]
    r = gan.Recipe(t, s.upsample, int(ctx.mix["data"]["sample_rate"]),
                   int(ctx.mix["data"]["n_mels"]))
    r.dropout = float(ctx.config["model"]["text_encoder"].get("dropout", 0.1))
    return s, r, bool(t["discriminator_spectral_norm"])


def _reference(ctx, rounding: Optional[str] = None):
    """(step function of one input, whether the EMA runs): the reference's,
    or with ``rounding`` the control's."""
    s, r, spectral = recipe(ctx)
    q, qa = (gan.control_roundings(rounding) if rounding
             else (gan._same, gan._same))

    def one(st, inp):
        batch, drop_seed, off_seed = inp
        return gan.step(st, s, r, batch, drop_seed, off_seed, q, qa,
                        spectral)
    return one, r.ema_decay > 0


def follow(ctx, g0, d0, inputs, before, rounding: Optional[str] = None
           ) -> List[Dict]:
    """The reference's (or with ``rounding`` the control's) records of the
    compared steps: the first ones from the seed's weights, the last from
    the program's state ``before`` it."""
    one, ema = _reference(ctx, rounding)
    out = []
    with ref.exact():
        st = gan.State.start(g0, d0, ema)
        for k, inp in enumerate(inputs[:-1]):
            st, losses, tensors = one(st, inp)
            grads = {n: tc.leaf_norms(v) for n, v in tensors.items()}
            rec = {"losses": losses}
            if k == 0:
                rec["grad"] = first = grads
                rec["grad_tensors"] = tensors
            if k == len(inputs) - 2:
                rec["change"] = {"g": tc.diff_norms(st.g, g0),
                                 "d": tc.diff_norms(st.d, d0)}
                rec["grad_for_change"] = first
            out.append(rec)
        del st
        out.append(follow_past(one, before, inputs[-1]))
    return out


def follow_past(one, before: Dict, inp: Tuple) -> Dict:
    """The record of one reference step (``one``) from the program's state
    ``before`` (a ``Side.snapshot``) on the input ``inp``."""
    b = before

    def moments(net):  # none before a net's first update: zeros
        return [{k: m.get(k, torch.zeros_like(p)) for k, p in
                 b[net].items()} for m in (b[f"{net}_m"], b[f"{net}_v"])]
    st = gan.State(b["g"], b["d"], gan.Adam(*moments("g"), b["g_count"]),
                   gan.Adam(*moments("d"), b["d_count"]), b["ema"],
                   b["g_updates"])
    nxt, losses, tensors = one(st, inp)
    grads = {n: tc.leaf_norms(v) for n, v in tensors.items()}
    change = {"g": tc.diff_norms(nxt.g, b["g"]),
              "d": tc.diff_norms(nxt.d, b["d"])}
    if nxt.ema is not None:
        change["ema"] = tc.diff_norms(nxt.ema, b["ema"])
    return {"losses": losses, "grad": grads, "grad_tensors": tensors,
            "change": change, "past": True, "grad_for_change": grads}


def check(ctx, g0, d0, inputs, before, prog, control: Optional[str]):
    """(the program's numbers against the reference, and with ``control``
    the control's against it)."""
    t0 = time.perf_counter()
    want = follow(ctx, g0, d0, inputs, before)
    nums = tc.numbers(prog, want)
    say(f"reference: {len(want)} steps in {time.perf_counter() - t0:.1f} s; "
        f"worst: {nums['worst']}; readings (median, worst leaf, where): "
        f"{nums['readings']}")
    say("losses (program / reference): " + "; ".join(
        f"step {i}: " + ", ".join(
            f"{k} {p['losses'].get(k, 0.0):.6g}/{v:.6g}"
            for k, v in r["losses"].items())
        for i, (p, r) in enumerate(zip(prog, want))))
    other = None
    if control:
        got = follow(ctx, g0, d0, inputs, before, control)
        other = tc.numbers(got, want)
        say(f"control {control}: {other}")
    return nums, other
