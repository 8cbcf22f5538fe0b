"""Stage-1 trainer in PyTorch: masked mel L1 + duration MSE over bucketed
batches, AdamW with a warmup-cosine schedule, checkpoints the serving path
loads.

Counterpart of ``m2tts_tpu/training/trainer.py``, held to the same
arithmetic:

- the optimizer is optax's ``chain(clip_by_global_norm, adamw(schedule))``,
  inside ``MultiSteps`` when ``gradient_accumulation_steps`` > 1: the clip
  scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``,
  computed on the device; AdamW (eps 1e-8 outside the sqrt, weight decay on
  every parameter, times the scheduled lr) is ``torch.optim.AdamW`` with one
  parameter group; accumulation applies the running mean of k micro-step
  gradients every k-th step and leaves the weights untouched in between.
  The schedule and Adam's bias correction count applied updates
  (``Optimizer.count``), ``Stage1Trainer.step`` counts micro-steps;
- bf16 casts the f32 weights to bf16 and differentiates through the cast
  (``torch.func.functional_call`` on the cast copies), so the gradients and
  the optimizer stay f32; outputs are upcast to f32 before the loss;
- dropout draws from one explicit generator reseeded every step from
  (seed + 1, step, blow-ups), so the noise at step s is the same in a
  resumed run as in an uninterrupted one;
- a step never waits for the device: losses stay device tensors and are
  read on the host only at log steps, where the blow-up check runs;
- an OOM in the forward or backward pass drops the step's gradients and
  goes on; an OOM inside the optimizer update (which may have updated some
  tensors) restores the last host snapshot and rewinds the step. Non-finite
  losses rewind to the same snapshot, a bounded number of times.

The state a checkpoint holds is ``{"params": state_dict, "opt_state":
Optimizer.state_dict(), "step": int}``; ``utils.checkpoint.load_for_inference``
and ``serving.pipeline.from_checkpoint`` serve it as it is. One device only:
a data or model mesh axis above 1 waits for ROADMAP item 12.
"""

from __future__ import annotations

import json
import logging
import math
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from m2tts_tpu_torch.data.dataset import (DummyDataset, TTSDataset,
                                          data_iterator, make_batches)
from m2tts_tpu_torch.data.prefetch import BatchTransfer, DevicePrefetcher
from m2tts_tpu_torch.frontend.audio import AudioProcessor
from m2tts_tpu_torch.models.components import Dropout
from m2tts_tpu_torch.models.tts_model import build_model, init_params
from m2tts_tpu_torch.training.losses import stage1_losses
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.device import (MemoryTracker, ThermalMonitor,
                                          resolve_device)
from m2tts_tpu_torch.utils.metrics_logger import MetricsLogger
from m2tts_tpu_torch.utils.profiling import StepProfiler
from m2tts_tpu_torch.utils.tree import cast_params_bf16, tree_finite

logger = logging.getLogger(__name__)

_F32 = np.float32


def _write_best_score(ckpt_dir, step: int, score: float,
                      metric: str = "") -> None:
    """Record the best-validation score (and which metric produced it)
    beside the pinned checkpoint, so a resumed run never overwrites the
    true best with a worse state."""
    path = Path(ckpt_dir) / "best" / "score.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"step": int(step), "score": float(score),
                                "metric": str(metric)}))


def _read_best_score(ckpt_dir, default: float, metric: str = "") -> float:
    """Stored best score, or ``default`` when none exists, or when the
    stored score was produced by a different metric (a missing 'metric'
    field counts as different): scores on two scales never compare."""
    path = Path(ckpt_dir) / "best" / "score.json"
    if path.exists():
        try:
            data = json.loads(path.read_text())
            stored_metric = str(data.get("metric", ""))
            if metric and stored_metric != metric:
                logger.warning(
                    "best/score.json was produced by metric %r but this "
                    "run gates on %r — resetting the best score",
                    stored_metric or "<unrecorded>", metric)
                return default
            return float(data["score"])
        except (ValueError, KeyError):
            pass
    return default


# -- learning-rate schedules: optax's, in float32 as optax computes them ---

def _linear_schedule(init: float, end: float, steps: int
                     ) -> Callable[[int], float]:
    """``optax.linear_schedule(init, end, steps)``."""
    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(int(count), 0), steps)) / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))

    return schedule


def _warmup_cosine_schedule(peak: float, warmup: int, decay_steps: int
                            ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)``
    with end value 0: the linear warmup joined to a cosine decay over
    ``decay_steps - warmup`` steps."""
    warm = _linear_schedule(0.0, peak, warmup)
    span = decay_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return warm(count)
        c = _F32(min(int(count) - warmup, span))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(span)))
        return float(_F32(peak) * cosine)

    return schedule


def make_lr_schedule(cfg) -> Callable[[int], float]:
    """lr as a function of the applied-update count (optax's ``count``)."""
    lr = float(cfg.get("learning_rate", 1e-4))
    warmup = int(cfg.get("warmup_steps", 0))
    max_steps = int(cfg.get("max_steps", 10000))
    kind = cfg.get("lr_scheduler", "cosine")
    if kind == "cosine":
        warmup = max(warmup, 1)
        return _warmup_cosine_schedule(lr, warmup,
                                       max(max_steps, warmup + 1))
    if kind == "constant":
        if warmup:
            return _linear_schedule(0.0, lr, warmup)
        return lambda count: float(_F32(lr))
    raise ValueError(f"Unknown lr_scheduler {kind!r}")


# -- the optimizer ---------------------------------------------------------

def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay))``, inside ``MultiSteps(k)`` for
    ``gradient_accumulation_steps`` k > 1, over ``torch.optim.AdamW``.

    ``update(grads)`` takes one micro-step's gradients. Under
    accumulation it folds them into the running mean ``acc += (g - acc) /
    (mini_step + 1)`` and applies an update every k-th call, with the
    accumulator then zeroed. ``count`` is the number of applied updates,
    which the schedule and Adam's bias correction see. Nothing here waits
    for the device.
    """

    def __init__(self, cfg, named_params: Iterable[Tuple[str, torch.Tensor]]):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = make_lr_schedule(cfg)
        self.max_norm = float(cfg.get("gradient_clip_norm", 5.0))
        self.k = int(cfg.get("gradient_accumulation_steps", 1))
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0,
            betas=(float(cfg.get("adam_b1", 0.9)),
                   float(cfg.get("adam_b2", 0.999))),
            eps=1e-8, weight_decay=float(cfg.get("weight_decay", 1e-6)))
        self.count = 0
        self.mini_step = 0
        self.acc: Optional[List[torch.Tensor]] = (
            [torch.zeros_like(p) for p in self.params] if self.k > 1
            else None)

    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``optax.clip_by_global_norm``: ``(g / norm) * max_norm`` when
        ``norm >= max_norm``, else ``g`` unchanged, chosen on the device."""
        norm = global_norm(grads)
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        denom = torch.where(keep, one, norm)
        scale = torch.where(keep, one, torch.full_like(norm, self.max_norm))
        return torch._foreach_mul(torch._foreach_div(list(grads), denom),
                                  scale)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            if n + 1 < self.k:
                self.mini_step = n + 1
                return
            grads = self.acc
        for p, g in zip(self.params, self.clip(grads)):
            p.grad = g
        self.adamw.param_groups[0]["lr"] = self.schedule(self.count)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
            self.mini_step = 0

    def state_dict(self) -> Dict:
        """optax's state in the port's names: Adam's moments ``mu``/``nu``
        by parameter name (empty before the first update), the applied
        ``count``, and under accumulation ``acc_grads`` and
        ``mini_step``."""
        mu, nu = {}, {}
        for n, p in zip(self.names, self.params):
            st = self.adamw.state.get(p)
            if st:
                mu[n], nu[n] = st["exp_avg"], st["exp_avg_sq"]
        return {"count": self.count, "mu": mu, "nu": nu,
                "mini_step": self.mini_step,
                "acc_grads": (None if self.acc is None
                              else dict(zip(self.names, self.acc)))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        self.adamw.state.clear()
        for n, p in zip(self.names, self.params):
            if n in state["mu"]:
                self.adamw.state[p] = {
                    "step": torch.tensor(float(self.count),
                                         dtype=torch.float32),
                    "exp_avg": state["mu"][n].to(p.device, p.dtype,
                                                 copy=True),
                    "exp_avg_sq": state["nu"][n].to(p.device, p.dtype,
                                                    copy=True)}
        if self.acc is not None:
            acc = state.get("acc_grads")
            for n, a in zip(self.names, self.acc):
                a.copy_(acc[n]) if acc else a.zero_()


def build_dataset(cfg, keep_audio: bool = False):
    """TTSDataset when the data dir has content, else a DummyDataset over
    the configured buckets, so training runs data-free and reaches every
    bucket's shapes."""
    data_dir = Path(cfg.get("data_dir", "data/ljspeech"))
    n_mels = int(cfg.get("n_mels", 64))
    has_data = data_dir.exists() and (
        (data_dir / "metadata.csv").exists()
        or next(data_dir.glob("**/*.wav"), None) is not None)
    if has_data:
        ap = AudioProcessor.from_config(cfg)
        return TTSDataset(
            data_dir, audio_processor=ap,
            subset_size=cfg.get("subset_size"),
            max_text_length=int(cfg.get("max_text_length", 256)),
            max_mel_length=int(cfg.get("max_mel_length", 1000)),
            keep_audio=keep_audio)
    logger.warning("No data found in %s — using DummyDataset", data_dir)
    buckets = [tuple(b) for b in cfg.get("buckets", [[64, 256]])]
    max_text = min(int(cfg.get("max_text_length", 256)),
                   max(t for t, _ in buckets))
    max_mel = min(int(cfg.get("max_mel_length", 1000)),
                  max(m for _, m in buckets))
    return DummyDataset(size=256, mel_dim=n_mels,
                        max_text_length=max_text,
                        max_mel_length=max_mel,
                        keep_audio=keep_audio,
                        hop_length=int(cfg.get("hop_length", 256)))


def _to_host(tree):
    """A CPU copy of every tensor in a nest of dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v) for v in tree]
    return tree


class Stage1Trainer:
    """Acoustic-model training: masked mel L1 + duration MSE."""

    def __init__(self, config: Config, dataset=None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        data_axis = int(config.get("system.mesh.data", -1))
        model_axis = int(config.get("system.mesh.model", 1))
        if data_axis not in (-1, 1) or model_axis != 1:
            raise NotImplementedError(
                f"system.mesh data={data_axis} model={model_axis}: training "
                "runs on one device until multi-GPU (ROADMAP item 12) is "
                "ported; set data to 1 or -1 and model to 1")
        tcfg = config.get("training", Config())
        self.max_steps = int(tcfg.get("max_steps", 10000))
        self.batch_size = int(tcfg.get("batch_size", 32))
        self.bf16 = bool(tcfg.get("bf16", True))
        self.mel_weight = float(tcfg.get("mel_loss_weight", 1.0))
        self.duration_weight = float(tcfg.get("duration_loss_weight", 0.1))
        self.log_every = int(tcfg.get("log_every", 50))
        self.save_every = int(tcfg.get("save_every", 1000))
        self.validate_every = int(tcfg.get("validate_every", 500))
        self.seed = int(tcfg.get("seed", 1234))
        # host->device dtype of the mel/audio targets: bf16 halves the
        # copy's bytes; the loss upcasts to f32 on the device
        td = tcfg.get("transfer_dtype", None)
        self.transfer_dtype = torch.bfloat16 if td in ("bfloat16", "bf16") \
            else (torch.float16 if td in ("float16", "fp16") else None)
        # stage every batch of an epoch on the device once: no per-step
        # copy; batch composition is fixed across epochs (only the order
        # reshuffles); streams instead when over the budget
        self.device_data_cache = bool(tcfg.get("device_data_cache", False))
        self.device_cache_max_gb = float(
            tcfg.get("device_data_cache_max_gb", 4.0))

        self.model_config = config.get("model", Config())
        self.model = init_params(build_model(self.model_config),
                                 torch.Generator().manual_seed(self.seed),
                                 self.device).train()
        self.dataset = dataset if dataset is not None else build_dataset(
            config.get("data", Config()))
        self.buckets = [tuple(b) for b in config.get(
            "data.buckets", [[64, 256], [128, 512], [256, 1000]])]
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self._params = [p for _, p in self.model.named_parameters()]
        self.optimizer = Optimizer(tcfg, self.model.named_parameters())
        self._noise = torch.Generator(device=self.device)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self._noise
        self._transfer = BatchTransfer(self.device, self.transfer_dtype)

        out_dir = Path(config.get("paths.output_dir", "outputs/stage1"))
        self.ckpt = CheckpointManager(
            config.get("paths.checkpoint_dir", out_dir / "checkpoints"),
            max_to_keep=int(tcfg.get("max_checkpoints", 5)))
        self.metrics = MetricsLogger(
            config.get("paths.log_dir", out_dir / "logs"),
            backend=config.get("system.log_metrics", "csv"),
            wandb_project=config.get("system.wandb_project"),
            run_name=config.get("system.run_name"))
        self.memory = MemoryTracker(self.device)
        self.thermal = ThermalMonitor(
            threshold_c=float(config.get("system.thermal_threshold", 80.0)))
        self.profiler = StepProfiler.from_config(config)

        self.step = 0
        # best-validation checkpoint, pinned against rotation under
        # <ckpt_dir>/best
        self.best_val_loss = float("inf")
        self._best_ckpt: Optional[CheckpointManager] = None
        self.validate_samples = bool(tcfg.get("validate_samples", True))
        self._sample_validator = None
        # host snapshot (state, step) that an OOM inside the optimizer
        # update and a loss blow-up restore; refreshed at every checkpoint
        # save and at resume
        self._oom_snapshot = (self._host_state_copy(), 0)
        self._blowups = 0
        self._blowup_limit = int(config.get("training.max_loss_blowups", 3))

    @property
    def sample_validator(self):
        if self._sample_validator is None:
            from m2tts_tpu_torch.training.validation import \
                validator_from_config

            self._sample_validator = validator_from_config(
                self.config, build_model(self.model_config), stage=1,
                device=self.device)
        return self._sample_validator

    # -- state -------------------------------------------------------------
    def _host_state_copy(self) -> Dict:
        return {"params": _to_host(self.model.state_dict()),
                "opt_state": _to_host(self.optimizer.state_dict()),
                "step": self.step}

    def _restore(self, state: Dict, step: int) -> None:
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(step)

    def _clear_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _recover_after_blowup(self) -> None:
        """Rewind to the last finite snapshot after non-finite losses.

        The data stream is not rewound and the blow-up count enters the
        dropout seed, so the replayed window sees other batches and other
        noise. Raises after ``training.max_loss_blowups`` rewinds."""
        self._blowups += 1
        blown_step = self.step
        # restore before the limit check: when the raise fires, train()'s
        # finally-save must persist the last finite snapshot
        self._restore(*self._oom_snapshot)
        if self._blowups > self._blowup_limit:
            raise RuntimeError(
                f"non-finite losses at step {blown_step} — "
                f"{self._blowups - 1} rewinds already spent; lower the "
                "learning rate or raise training.max_loss_blowups")
        logger.error(
            "Non-finite losses at step %d — rewinding to snapshot step %d "
            "(blow-up %d/%d)", blown_step, self.step, self._blowups,
            self._blowup_limit)

    # -- steps -------------------------------------------------------------
    def _noise_seed(self, step: int) -> int:
        return int(np.random.SeedSequence(
            [self.seed + 1, int(step), self._blowups]).generate_state(1)[0])

    def _loss_fn(self, batch: Dict[str, torch.Tensor]):
        args = (batch["phoneme_ids"], batch["text_lengths"],
                batch["durations"])
        kwargs = {"max_frames": batch["mel"].shape[1]}
        if self.bf16:
            out = torch.func.functional_call(
                self.model,
                cast_params_bf16(dict(self.model.named_parameters())),
                args, kwargs)
        else:
            out = self.model(*args, **kwargs)
        losses = stage1_losses(
            out["mel_output"].float(), batch["mel"].float(),
            out["duration_pred"].float(), batch["durations"],
            batch["mel_lengths"], self.mel_weight, self.duration_weight)
        return losses["total_loss"], losses

    def _forward_backward(self, batch: Dict[str, torch.Tensor]):
        """(losses with ``grad_norm``, the raw gradient of every parameter
        in ``param_names`` order; zeros for the vocoder's, which the loss
        does not reach)."""
        self._noise.manual_seed(self._noise_seed(self.step))
        loss, losses = self._loss_fn(batch)
        grads = torch.autograd.grad(loss, self._params,
                                    materialize_grads=True)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = global_norm(grads)
        return losses, grads

    def _train_step(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        losses, grads = self._forward_backward(batch)
        self.optimizer.update(grads)
        return losses

    def _guarded_step(self, batch: Dict[str, torch.Tensor]
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """One micro-step; None after an out-of-memory error, recovered."""
        try:
            losses, grads = self._forward_backward(batch)
        except torch.cuda.OutOfMemoryError:
            # weights and optimizer untouched: drop the gradients, go on
            logger.error("OOM in the forward/backward pass at step %d; "
                         "clearing caches", self.step)
            self._clear_cache()
            return None
        try:
            self.optimizer.update(grads)
        except torch.cuda.OutOfMemoryError:
            # the update may have written some tensors: restore all
            del grads
            self._clear_cache()
            snap_step = self._oom_snapshot[1]
            logger.error("OOM in the optimizer update at step %d — "
                         "restoring the last snapshot (step %d)",
                         self.step, snap_step)
            self._restore(*self._oom_snapshot)
            return None
        return losses

    @torch.no_grad()
    def _eval_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        self.model.eval()
        try:
            return self._loss_fn(batch)[1]
        finally:
            self.model.train()

    # -- loop --------------------------------------------------------------
    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return self._transfer.transfer(batch)

    def _device_cached_iterator(self):
        """Infinite iterator over device-resident batches (one copy each,
        ever), in a fresh shuffled order each epoch; None when the staged
        bytes would exceed the budget."""
        from m2tts_tpu_torch.data.device_cache import (epoch_shuffled,
                                                       stage_on_device)

        staged = stage_on_device(
            make_batches(self.dataset, self.batch_size, self.buckets,
                         seed=self.seed, shuffle=True, drop_last=False),
            self._put, self.device_cache_max_gb * 1e9)
        return epoch_shuffled(staged, self.seed + 17) if staged else None

    def train(self, resume: bool = False) -> Dict[str, float]:
        if resume and self.ckpt.latest_step() is not None:
            state, _, step = self.ckpt.restore()
            self._restore(state, step)
            # recovery must roll back to the resumed state, not the init
            self._oom_snapshot = (self._host_state_copy(), step)
            # without it the first validation after a resume would always
            # "improve" on inf and replace the genuine best checkpoint
            self.best_val_loss = _read_best_score(
                self.ckpt.directory, self.best_val_loss,
                metric="val_total_loss")
            logger.info("Resumed from step %d", step)

        it = self._device_cached_iterator() if self.device_data_cache else None
        if it is None:
            depth = int(self.config.get("data.prefetch", 2))
            source = data_iterator(self.dataset, self.batch_size,
                                   self.buckets, seed=self.seed)
            it = (DevicePrefetcher(source, self._transfer.put, depth,
                                   ready_fn=self._transfer.ready)
                  if depth > 0 else map(self._put, source))
        last: Dict[str, float] = {}
        t_last = time.perf_counter()
        try:
            while self.step < self.max_steps:
                if not self.thermal.check():
                    self.thermal.wait_for_cooldown()
                batch = next(it)
                with self.profiler.step(self.step):
                    losses = self._guarded_step(batch)
                if losses is None:
                    continue
                self.step += 1

                if self.step % self.log_every == 0:
                    # the one host read of the interval
                    last = dict(zip(losses, torch.stack(
                        list(losses.values())).tolist()))
                    if not all(math.isfinite(v) for v in last.values()):
                        self._recover_after_blowup()
                        t_last = time.perf_counter()
                        continue
                    now = time.perf_counter()
                    last["steps_per_sec"] = self.log_every / (now - t_last)
                    t_last = now
                    last.update(self.memory.update())
                    self.metrics.log(last, self.step)
                    logger.info("step %d: %s", self.step,
                                {k: round(v, 4) for k, v in last.items()})
                if self.step % self.validate_every == 0:
                    val = self.validate()
                    if self.validate_samples:
                        val.update(self.sample_validator.run(
                            self.model.state_dict(), self.step))
                    self.metrics.log({f"val_{k}": v for k, v in val.items()},
                                     self.step)
                    score = val.get("total_loss")
                    if score is not None and score < self.best_val_loss:
                        self.best_val_loss = score
                        self.save_best_checkpoint(score)
                if self.step % self.save_every == 0:
                    self.save_checkpoint()
        except KeyboardInterrupt:  # graceful final checkpoint
            logger.info("Interrupted at step %d — saving checkpoint", self.step)
        finally:
            if hasattr(it, "close"):
                it.close()
            self.profiler.close(self.step - 1)
            self.save_checkpoint()
            self.metrics.close()
        return last

    def validate(self, n_batches: int = 2) -> Dict[str, float]:
        # drop_last=False: a corpus smaller than one batch per bucket must
        # still validate, or the best checkpoint is never pinned
        it = make_batches(self.dataset, self.batch_size, self.buckets,
                          seed=0, shuffle=False, drop_last=False)
        totals: Dict[str, float] = {}
        count = 0
        for batch in it:
            losses = self._eval_step(self._put(batch))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
            if count >= n_batches:
                break
        return {k: v / max(count, 1) for k, v in totals.items()}

    def save_checkpoint(self) -> None:
        if self.step == 0:
            return
        host_state = self._host_state_copy()
        # a blow-up between log intervals must never poison the on-disk
        # latest checkpoint or the rewind snapshot
        if not tree_finite(host_state["params"]):
            logger.error("Refusing to checkpoint non-finite params at step "
                         "%d (blow-up not yet detected)", self.step)
            return
        self._oom_snapshot = (host_state, self.step)
        self.ckpt.save(self.step, host_state, config=self.config)

    def save_best_checkpoint(self, score: float) -> None:
        """Pin the current state as the best-validation checkpoint under
        ``<ckpt_dir>/best`` (survives rotation; served by
        ``from_checkpoint(dir, step="best")``)."""
        if self._best_ckpt is None:
            self._best_ckpt = CheckpointManager(
                self.ckpt.directory / "best", max_to_keep=1)
        self._best_ckpt.save(self.step, self._host_state_copy(),
                             config=self.config,
                             metrics={"val_total_loss": float(score)})
        _write_best_score(self.ckpt.directory, self.step, score,
                          metric="val_total_loss")
        logger.info("New best validation loss %.6f at step %d", score,
                    self.step)

    def close(self):
        self.ckpt.close()
        if self._best_ckpt is not None:
            self._best_ckpt.close()
        self.metrics.close()
