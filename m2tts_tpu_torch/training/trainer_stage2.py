"""Stage-2 GAN trainer in PyTorch: the text→waveform generator against a
multi-scale discriminator, on random segments of the ground-truth waveform.

Counterpart of ``m2tts_tpu/training/trainer_stage2.py``, held to the same
arithmetic:

- **the fused step** (``_gd_step``): the discriminator first, on
  ``cat([real, fake])`` with the fake from a generator forward in train
  mode under ``no_grad``; then the generator against the updated
  discriminator, its fake half differentiated through the discriminator to
  the generator, its real half forward only. Gradients are taken with
  ``torch.autograd.grad`` over one net's parameters, so neither net's
  update touches the other. Both generator forwards draw the same dropout
  masks: each draws from a generator of its own (``_noise_d``,
  ``_noise_g``), both seeded with (seed + 3, step, blow-ups) by the host
  before the step;
- **bf16** casts each net's f32 weights to bf16 inside the forward
  (``torch.func.functional_call``) and the discriminator's input to bf16;
  logits and features are upcast to f32 before the losses (and nothing is
  narrowed: with f64 weights and batch the whole step runs in f64);
- both nets use the port's ``Optimizer`` (optax's ``clip_by_global_norm`` +
  ``adamw``, b1 0.8 and b2 0.99 by default, ``MultiSteps`` under
  accumulation). ``g_updates``/``d_updates`` count each net's update calls,
  as flax's ``TrainState.step`` does, and set the adversarial warmup ramp,
  a 0-d f32 device tensor the host fills before each step (JAX traces it
  from ``g_state.step``);
- **the adaptive guards**: with ``adaptive_d_lr_floor`` the
  discriminator's applied update is scaled by ``clip(d_loss/floor, 0, 1)``
  (Adam's moments advance as without it); with
  ``adaptive_adv_dloss_floor`` the adversarial weight is scaled by
  ``clip(d_loss/floor, 0, 1)`` of the same batch, logged as ``adv_guard``.
  Both stay on the device;
- **EMA** of the generator after every generator update
  (``torch._foreach_*``); validation, the gate, ``best/`` and serving use
  it, and checkpoints carry it as ``generator_ema``;
- ``alternate_gd``: the discriminator on even steps, the generator on odd
  ones. There the generator step has no discriminator loss of its batch,
  so the adversarial guard cannot act; the trainer warns once at init;
- **data**: host segments from ``default_rng(seed + 2)``, the same offsets
  as the JAX package for the same seed; or, with ``device_data_cache``,
  whole waveforms staged on the device and windows drawn there from a
  ``torch.Generator`` (offsets from another stream than JAX's, in the same
  range);
- **guards**: an out-of-memory error drops the step, restoring the last
  host snapshot when an update had begun; non-finite losses at a log step
  rewind to the snapshot (restored before the raise) at most
  ``max_loss_blowups`` times; non-finite weights are never checkpointed;
- **CUDA graphs** (``utils/graphs.py``), the counterparts of JAX's jitted
  ``_gd_step``/``_gd_step_cached``, ``_d_step``/``_g_step`` and
  ``_val_fwd``: on CUDA (without a mesh, or on an NCCL mesh, where the
  graph holds the collectives) a step is one graph replay per
  (bucket, mode), the mode being fused or D or G, host or device-cached
  batch, and under accumulation each optimizer's branch (accumulate, or
  accumulate and apply). The graph holds the window cut, both losses and
  gradients, the guarded D update, the G update and the EMA; the host
  seeds the three generators (registered with the graph), fills the ramp,
  the lrs and the accumulation divisors, and keeps the counts. A bucket's
  first step runs eagerly and captures; an OOM there restores the last
  snapshot; an optimizer state load (restore, resume, a blow-up rewind)
  drops the graphs. Validation's forward is one graph per bucket with the
  scored weights as its inputs (on a mesh rank 0's alone, which validates).
  On the CPU, on a gloo mesh and inside ``disable_graphs()`` all of it runs
  eagerly.

A checkpoint holds ``{"generator", "g_opt_state", "discriminator",
"d_opt_state", "step"}`` and ``generator_ema``; ``load_for_inference`` and
``serving.pipeline.from_checkpoint`` serve its EMA. ``disc_lowering``
picks the discriminator's lowering: ``native`` runs the module's convs,
``packed`` the same function through ``packed_multiscale_apply`` (the
strided grouped convs phase-packed into stride-1 convs) on the same
parameters; ``auto`` is ``native`` (JAX picks ``packed`` on a TPU only), and
spectral norm forces ``native``.

On a ('data', 'model') mesh (``mesh=``, or ``system.mesh`` under
``torchrun``) the generator is placed by the TP rules and the
discriminator, which no rule matches, is replicated, as in JAX; every
weight is a DTensor, and the forwards, both optimizers and the EMA run on
the local tensors (a checkpoint places each moment and shadow as its
weight before the gather). Each rank prepares
the same global batch (windows and noise drawn over all its rows) and
keeps its rows; gradients and losses are averaged over 'data', so the
guards see the global discriminator loss. Validation gathers the scored
weights and runs on rank 0 with an unsharded copy of the generator; every
rank receives its metrics. Checkpoints hold the global weights, written
by rank 0.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from m2tts_tpu_torch.data.dataset import data_iterator, make_batches
from m2tts_tpu_torch.data.prefetch import BatchTransfer, DevicePrefetcher
from m2tts_tpu_torch.models.components import Dropout
from m2tts_tpu_torch.models.discriminator import (MultiScaleDiscriminator,
                                                  packed_multiscale_apply)
from m2tts_tpu_torch.models.tts_model import build_model, init_params
from m2tts_tpu_torch.parallel import mesh as pmesh
from m2tts_tpu_torch.parallel import partition
from m2tts_tpu_torch.training import losses as L
from m2tts_tpu_torch.training.losses import EarlyStopping
from m2tts_tpu_torch.training.trainer import (Optimizer, _full,
                                              _read_best_score, _rows,
                                              _to_host, _write_best_score,
                                              build_dataset)
from m2tts_tpu_torch.utils.checkpoint import CheckpointManager
from m2tts_tpu_torch.utils.config import Config
from m2tts_tpu_torch.utils.device import (MemoryTracker, ThermalMonitor,
                                          resolve_device)
from m2tts_tpu_torch.utils.graphs import step_graphs
from m2tts_tpu_torch.utils.metrics_logger import MetricsLogger
from m2tts_tpu_torch.utils.profiling import StepProfiler
from m2tts_tpu_torch.utils.tree import cast_params_bf16, tree_finite

logger = logging.getLogger(__name__)

# the stage-2 optimizers' defaults where the config is silent
_OPT_DEFAULTS = {"gradient_clip_norm": 1.0, "adam_b1": 0.8, "adam_b2": 0.99}
_DROPOUT, _OFFSETS = 0, 1  # noise streams of a step


def _segment_audio(audio: np.ndarray, mel_lengths: np.ndarray,
                   seg_frames: int, hop: int, upsample: int,
                   rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: a random mel-frame window per sample and the aligned
    ground-truth waveform at the vocoder's effective rate.

    Returns (offsets [B] int32, targets [B, seg_frames*upsample] float32).
    """
    B = audio.shape[0]
    offsets = np.zeros((B,), np.int32)
    targets = np.zeros((B, seg_frames * upsample), np.float32)
    need_resample = upsample != hop
    if need_resample:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(upsample, hop)
        up, down = upsample // g, hop // g
    for i in range(B):
        max_off = max(int(mel_lengths[i]) - seg_frames, 0)
        off = int(rng.integers(0, max_off + 1))
        offsets[i] = off
        seg = audio[i, off * hop: (off + seg_frames) * hop]
        if len(seg) < seg_frames * hop:
            seg = np.pad(seg, (0, seg_frames * hop - len(seg)))
        if need_resample:
            seg = resample_poly(seg, up, down).astype(np.float32)
        targets[i, : len(seg)] = seg[: seg_frames * upsample]
    return offsets, targets


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A bf16/f16 tensor upcast to f32 before any loss arithmetic; wider
    types pass unchanged (an f64 step stays f64)."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _upcast(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """bf16/f16 transfer tensors → f32."""
    return {k: _f32(v) for k, v in batch.items()}


class Stage2Trainer:
    """GAN training over the full text→waveform stack. ``mesh``: a
    ('data', 'model') ``DeviceMesh``. ``mesh=None`` is the single-device
    path only without a process group: under one (torchrun) the mesh is
    built from ``system.mesh``, the whole world by default."""

    def __init__(self, config: Config, dataset=None, device="cuda",
                 mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = (mesh if mesh is not None
                     else pmesh.mesh_from_config(config, self.device))
        self.is_main = self.mesh is None or dist.get_rank() == 0
        tcfg = config.get("training", Config())
        self.max_steps = int(tcfg.get("max_steps", 50000))
        self.batch_size = int(tcfg.get("batch_size", 32))
        self.bf16 = bool(tcfg.get("bf16", True))
        self.alternate_gd = bool(tcfg.get("alternate_gd", False))
        self.log_every = int(tcfg.get("log_every", 100))
        self.save_every = int(tcfg.get("save_every", 2000))
        self.validate_every = int(tcfg.get("validate_every", 1000))
        self.seed = int(tcfg.get("seed", 1234))
        td = tcfg.get("transfer_dtype", None)
        self.transfer_dtype = torch.bfloat16 if td in ("bfloat16", "bf16") \
            else (torch.float16 if td in ("float16", "fp16") else None)
        self.hop = int(config.get("data.hop_length", 256))
        self.device_data_cache = bool(tcfg.get("device_data_cache", False))
        self.device_cache_max_gb = float(
            tcfg.get("device_data_cache_max_gb", 4.0))
        self.weights = dict(
            mel_weight=float(tcfg.get("mel_loss_weight", 1.0)),
            duration_weight=float(tcfg.get("duration_loss_weight", 0.1)),
            adversarial_weight=float(tcfg.get("adversarial_loss_weight", 0.25)),
            feature_matching_weight=float(
                tcfg.get("feature_matching_weight", 2.0)),
            spectral_weight=float(tcfg.get("spectral_loss_weight", 1.0)),
            perceptual_weight=float(tcfg.get("perceptual_loss_weight", 0.5)),
            envelope_weight=float(tcfg.get("envelope_loss_weight", 0.0)),
        )
        self.stft_phase_weight = float(tcfg.get("stft_phase_weight", 0.1))
        # adv + FM weights ramp 0→1 over this many generator updates
        self.adv_warmup = int(tcfg.get("adversarial_warmup_steps", 0))
        self.adaptive_adv_floor = float(
            tcfg.get("adaptive_adv_dloss_floor", 0.0))
        self.adaptive_d_lr_floor = float(
            tcfg.get("adaptive_d_lr_floor", 0.0))
        self.ema_decay = float(tcfg.get("ema_decay", 0.0))
        if self.alternate_gd and self.adaptive_adv_floor > 0:
            logger.warning(
                "training.adaptive_adv_dloss_floor has no effect under "
                "training.alternate_gd: a generator step has no "
                "discriminator loss of its own batch, so the adversarial "
                "guard stays at full weight")

        self.model = init_params(build_model(config.get("model", Config())),
                                 torch.Generator().manual_seed(self.seed),
                                 self.device).train()
        self.discriminator = init_params(
            MultiScaleDiscriminator(spectral_norm=bool(
                tcfg.get("discriminator_spectral_norm", False))),
            torch.Generator().manual_seed(self.seed), self.device).train()
        disc_lowering = str(tcfg.get("disc_lowering", "auto"))
        if disc_lowering not in ("auto", "native", "packed"):
            raise ValueError(f"Unknown disc_lowering {disc_lowering!r}")
        # 'auto' resolves as JAX's off a TPU; the packed apply reads the
        # raw weights, so spectral norm keeps the module
        self.disc_lowering = ("native" if disc_lowering == "auto"
                              or self.discriminator.spectral_norm
                              else disc_lowering)
        self.upsample = self.model.total_upsample
        seg_samples = int(tcfg.get("audio_segment_len", 8192))
        self.seg_frames = max(seg_samples // self.upsample, 8)
        self.n_mels = int(config.get("data.n_mels", self.model.mel_channels))

        self.dataset = dataset if dataset is not None else build_dataset(
            config.get("data", Config()), keep_audio=True)
        self.buckets = [tuple(b) for b in config.get(
            "data.buckets", [[64, 256], [128, 512], [256, 1000]])]

        init_from = tcfg.get("init_generator_from")
        if init_from:
            from m2tts_tpu_torch.utils.checkpoint import load_for_inference

            state_dict, _, from_step = load_for_inference(init_from)
            self.model.load_state_dict(state_dict)
            logger.info("Generator warm-started from %s (step %d)",
                        init_from, from_step)
        # validation's generator: on a mesh an unsharded copy on rank 0,
        # which validates for all
        self._eval_model = self.model
        if self.mesh is not None:
            n_data = pmesh.batch_sharding(self.mesh)[1]
            if self.batch_size % n_data:
                raise ValueError(f"training.batch_size {self.batch_size} not "
                                 f"divisible by the mesh 'data' axis "
                                 f"({n_data})")
            self._eval_model = (build_model(config.get("model", Config())).to(
                self.device).train() if self.is_main else None)
            for net in (self.model, self.discriminator):
                pmesh.replicate_tree(net.state_dict(), self.mesh)
                partition.shard_module(net, self.mesh)

        opt_cfg = Config(_OPT_DEFAULTS).merge(tcfg)
        # the step, validation's forward: one CUDA graph per bucket key
        # (None on the CPU and on a gloo mesh, which run eagerly)
        self._graphs = step_graphs(self.device, self.mesh)
        capturable = self._graphs is not None
        self.g_opt = Optimizer(opt_cfg, self.model.named_parameters(),
                               capturable=capturable)
        self.d_opt = Optimizer(opt_cfg, self.discriminator.named_parameters(),
                               capturable=capturable)
        # what the forwards run on and the gradients are taken by: the
        # optimizers' tensors (on a mesh the local ones)
        self.g_names, self.g_params = self.g_opt.names, self.g_opt.params
        self.d_names, self.d_params = self.d_opt.names, self.d_opt.params
        self._graph_loads = (self.g_opt.loads, self.d_opt.loads)
        self.g_updates = 0
        self.d_updates = 0
        # the generator's EMA shadow, on the local tensors as the optimizer
        self.ema: Optional[List[torch.Tensor]] = (
            [p.detach().clone() for p in self.g_params]
            if self.ema_decay > 0 else None)
        # the adversarial warmup ramp of the next G step, filled by the host
        self._ramp = torch.zeros((), dtype=torch.float32, device=self.device)
        # dropout of D's fake forward and of G's forward: two generators
        # seeded alike, so the two draw the same masks
        self._noise_d = torch.Generator(device=self.device)
        self._noise_g = torch.Generator(device=self.device)
        self._dropouts = [m for m in self.model.modules()
                          if isinstance(m, Dropout)]
        self._offsets = torch.Generator(device=self.device)
        self._transfer = BatchTransfer(self.device, self.transfer_dtype)

        out_dir = Path(config.get("paths.output_dir", "outputs/stage2"))
        self.ckpt = CheckpointManager(
            config.get("paths.checkpoint_dir", out_dir / "checkpoints"),
            max_to_keep=int(tcfg.get("max_checkpoints", 10)))
        self.metrics = MetricsLogger(
            config.get("paths.log_dir", out_dir / "logs"),
            backend=(config.get("system.log_metrics", "csv") if self.is_main
                     else "none"),
            wandb_project=config.get("system.wandb_project"),
            run_name=config.get("system.run_name"))
        self.memory = MemoryTracker(self.device)
        self.thermal = ThermalMonitor(
            threshold_c=float(config.get("system.thermal_threshold", 80.0)))
        self.profiler = StepProfiler.from_config(config)
        self.early_stopping = EarlyStopping(
            patience=int(tcfg.get("patience", 10000)),
            min_delta=float(tcfg.get("min_delta", 0.001)))
        self.best_val_score = float("inf")
        self._best_ckpt: Optional[CheckpointManager] = None

        self._host_rng = np.random.default_rng(self.seed + 2)
        self.step = 0
        self._blowups = 0
        self._blowup_limit = int(tcfg.get("max_loss_blowups", 3))
        # host snapshot that an OOM mid-update and a loss blow-up restore;
        # refreshed at every checkpoint save and at restore
        self._oom_snapshot = self._snapshot()
        self._updating = False  # an update of this step has begun
        self.validate_quality = bool(tcfg.get("validate_quality", True))
        # weight on (1 - full-utterance STOI) in the validation gate
        self.gate_stoi_weight = float(tcfg.get("gate_stoi_weight", 4.0))
        self.quality_utterances = int(tcfg.get("quality_utterances", 16))
        self.generate_samples_every = int(config.get(
            "system.generate_samples_every", 0))
        self._sample_validator = None
        self._bm_cache: Dict = {}

    # -- state -------------------------------------------------------------
    def _eval_params(self) -> Dict[str, torch.Tensor]:
        """The generator weights that validation, the gate and ``best/``
        score: the EMA shadow when on, else the live weights (gathered to
        the global tensors on a mesh)."""
        params = self.ema if self.ema is not None else self.g_params
        return _full(self._placed(params), self.mesh)

    def _placed(self, tensors: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Tensors of the generator's local shapes by name, each placed as
        its parameter (a DTensor on a mesh, for ``_full``'s gather)."""
        return {n: partition.place_like(t.detach(), q) for n, t, q in zip(
            self.g_names, tensors, self.g_opt.placed)}

    def _host_state(self) -> Dict[str, Any]:
        state = {"generator": self.model.state_dict(),
                 "g_opt_state": self.g_opt.state_dict(),
                 "discriminator": self.discriminator.state_dict(),
                 "d_opt_state": self.d_opt.state_dict(),
                 "step": self.step}
        if self.ema is not None:
            state["generator_ema"] = self._placed(self.ema)
        return _to_host(_full(state, self.mesh))

    @torch.no_grad()
    def _load_state(self, state: Dict[str, Any],
                    ema: Optional[Dict[str, torch.Tensor]]) -> None:
        nets = {"generator": self.model, "discriminator": self.discriminator}
        for key, net in nets.items():
            net.load_state_dict(state[key] if self.mesh is None else
                                partition.shard_tree(state[key], self.mesh))
        self.g_opt.load_state_dict(state["g_opt_state"])
        self.d_opt.load_state_dict(state["d_opt_state"])
        if self.ema is not None:
            for n, e, q in zip(self.g_names, self.ema, self.g_opt.placed):
                e.copy_(ema[n] if self.mesh is None
                        else partition.shard_like(ema[n], q).to_local())

    def _snapshot(self) -> Tuple:
        return (self._host_state(), self.step, self.g_updates,
                self.d_updates)

    def _restore_snapshot(self, snap: Tuple) -> None:
        state, self.step, self.g_updates, self.d_updates = snap
        self._load_state(state, state.get("generator_ema"))

    def _clear_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _recover_after_blowup(self) -> None:
        """Rewind to the last finite snapshot after non-finite losses.

        The data stream is not rewound and the blow-up count enters every
        noise seed, so the replayed window sees other batches and other
        noise. Raises after ``training.max_loss_blowups`` rewinds."""
        self._blowups += 1
        blown_step = self.step
        # restore before the limit check: when the raise fires, train()'s
        # finally-save must persist the last finite snapshot
        self._restore_snapshot(self._oom_snapshot)
        if self._blowups > self._blowup_limit:
            raise RuntimeError(
                f"non-finite losses at step {blown_step} — "
                f"{self._blowups - 1} rewinds already spent; lower the "
                "learning rate or raise training.max_loss_blowups")
        logger.error(
            "Non-finite losses at step %d — rewinding to snapshot step %d "
            "(blow-up %d/%d)", blown_step, self.step, self._blowups,
            self._blowup_limit)

    # -- forward pieces ----------------------------------------------------
    def _noise_seed(self, step: int, stream: int) -> int:
        return int(np.random.SeedSequence(
            [self.seed + 3, int(step), self._blowups, stream]
        ).generate_state(1)[0])

    def _cast(self, params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return cast_params_bf16(params) if self.bf16 else params

    @staticmethod
    def _live(names: Sequence[str], params: Sequence[torch.Tensor],
              detach: bool = False) -> Dict[str, torch.Tensor]:
        """The tensors a forward runs on by name (differentiable unless
        ``detach``)."""
        return {n: p.detach() if detach else p
                for n, p in zip(names, params)}

    def _acoustic_and_segment(self, g_params: Dict[str, torch.Tensor],
                              batch: Dict[str, torch.Tensor],
                              model: Optional[torch.nn.Module] = None):
        """Teacher-forced text→mel, the target window of each row sliced
        out, vocoded: (outputs, mel [B, T, C] f32, audio [B, S·U] f32).
        ``model`` defaults to the trained (on a mesh, sharded) generator."""
        model = self.model if model is None else model
        p = self._cast(g_params)
        out = torch.func.functional_call(
            model, p, (batch["phoneme_ids"], batch["text_lengths"],
                       batch["durations"]),
            {"max_frames": batch["mel"].shape[1]})
        mel_pred = out["mel_output"]
        B, T, C = mel_pred.shape
        # the window start clamped to fit, as lax.dynamic_slice clamps it
        start = batch["frame_offsets"].long().clamp(
            0, max(T - self.seg_frames, 0))
        rows = start[:, None] + torch.arange(self.seg_frames,
                                             device=start.device)
        mel_seg = torch.gather(mel_pred, 1, rows[..., None].expand(-1, -1, C))
        vocoder = {k[len("vocoder."):]: v for k, v in p.items()
                   if k.startswith("vocoder.")}
        audio = torch.func.functional_call(model.vocoder, vocoder,
                                           (mel_seg,))[..., 0]
        return out, _f32(mel_pred), _f32(audio)

    def _disc_apply(self, d_params: Dict[str, torch.Tensor],
                    audio: torch.Tensor, features: bool = True):
        """The discriminator under the compute-dtype policy: bf16 weights
        and input when ``bf16``, logits and features upcast to f32. Without
        ``features`` only the logits are returned (no f32 copies of the
        feature maps, which the discriminator's loss does not read)."""
        if self.bf16:
            audio = audio.to(torch.bfloat16)
        if self.disc_lowering == "packed":
            logits, feats = packed_multiscale_apply(
                self._cast(d_params), audio, scales=self.discriminator.scales)
        else:
            logits, feats = torch.func.functional_call(
                self.discriminator, self._cast(d_params), (audio,))
        logits = [_f32(l) for l in logits]
        if not features:
            return logits
        return logits, [[_f32(f) for f in fs] for fs in feats]

    def _use_noise(self, generator: torch.Generator) -> None:
        """Point every dropout of the generator at ``generator``."""
        for m in self._dropouts:
            m.generator = generator

    def _d_loss_and_grads(self, batch: Dict[str, torch.Tensor]):
        """LSGAN discriminator loss over ``[real; fake]`` in one apply and
        its gradient over the discriminator's parameters. The fake comes
        from a train-mode generator forward with the step's dropout."""
        with torch.no_grad():
            self._use_noise(self._noise_d)
            _, _, fake = self._acoustic_and_segment(
                self._live(self.g_names, self.g_params), batch)
        B = fake.shape[0]
        d_params = self._live(self.d_names, self.d_params)
        logits = self._disc_apply(
            d_params, torch.cat([batch["audio_seg"], fake]), features=False)
        d_loss = L.lsgan_discriminator_loss([l[:B] for l in logits],
                                            [l[B:] for l in logits])
        grads = torch.autograd.grad(d_loss, self.d_params,
                                    materialize_grads=True)
        d_loss = d_loss.detach()
        if self.mesh is not None:
            d_loss = pmesh.mean_dict_over({"d": d_loss}, self.mesh)["d"]
            pmesh.mean_over(grads, self.mesh)
        return d_loss, grads

    def _g_losses(self, g_params: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor],
                  d_loss: Optional[torch.Tensor] = None):
        """(total, losses) of the generator against the current
        discriminator (its weights detached)."""
        self._use_noise(self._noise_g)
        out, mel_pred, audio_pred = self._acoustic_and_segment(g_params, batch)
        target = batch["audio_seg"]
        sr = self._effective_sample_rate()
        losses = {
            "mel_loss": L.masked_mel_l1(mel_pred, batch["mel"],
                                        batch["mel_lengths"]),
            "duration_loss": L.duration_mse(_f32(out["duration_pred"]),
                                            batch["durations"]),
            "spectral_loss": L.multi_resolution_stft_loss(
                audio_pred, target, phase_weight=self.stft_phase_weight),
            "perceptual_loss": L.perceptual_loss(audio_pred, target,
                                                 sample_rate=sr,
                                                 n_mels=self.n_mels),
        }
        if self.weights["envelope_weight"] > 0:
            losses["envelope_loss"] = L.envelope_correlation_loss(
                audio_pred, target, sample_rate=sr)
        d_params = self._live(self.d_names, self.d_params, detach=True)
        # the fake half needs the backward; the real half is data, so its
        # features are constants and run forward only
        fake_logits, fake_feats = self._disc_apply(d_params, audio_pred)
        with torch.no_grad():
            _, real_feats = self._disc_apply(d_params, target)
        losses["generator_loss"] = L.lsgan_generator_loss(fake_logits)
        losses["feature_matching_loss"] = L.feature_matching_loss(
            real_feats, fake_feats)
        weights = dict(self.weights)
        if self.adv_warmup > 0:
            # the logged losses stay un-ramped; only the total is scheduled
            weights["adversarial_weight"] = (
                weights["adversarial_weight"] * self._ramp)
            weights["feature_matching_weight"] = (
                weights["feature_matching_weight"] * self._ramp)
        if self.adaptive_adv_floor > 0 and d_loss is not None:
            # a won discriminator (d_loss → 0) feeds saturated-logit
            # gradients to G: scale the adversarial weight (not FM) by how
            # balanced the game is, from this batch's d_loss
            guard = torch.clamp(d_loss / self.adaptive_adv_floor, 0.0, 1.0)
            weights["adversarial_weight"] = (
                weights["adversarial_weight"] * guard)
            losses["adv_guard"] = guard
        total = L.combined_generator_loss(losses, **weights)
        losses["total_loss"] = total
        return total, losses

    def _g_loss_and_grads(self, batch: Dict[str, torch.Tensor],
                          d_loss: Optional[torch.Tensor] = None):
        total, losses = self._g_losses(
            self._live(self.g_names, self.g_params), batch, d_loss)
        grads = torch.autograd.grad(total, self.g_params,
                                    materialize_grads=True)
        losses = {k: v.detach() for k, v in losses.items()}
        if self.mesh is not None:
            losses = pmesh.mean_dict_over(losses, self.mesh)
            pmesh.mean_over(grads, self.mesh)
        return losses, grads

    def _d_update(self, grads: Sequence[torch.Tensor],
                  d_loss: torch.Tensor, applies: bool) -> None:
        """The device half of D's update (``Optimizer.device_update``)."""
        guard = None
        if self.adaptive_d_lr_floor > 0:
            # a saturated discriminator slows its own update: Adam
            # normalises a gradient's scale away, so the update is scaled
            guard = torch.clamp(d_loss / self.adaptive_d_lr_floor, 0.0, 1.0)
        self._updating = True
        self.d_opt.device_update(grads, applies, scale=guard)

    @torch.no_grad()
    def _g_update(self, grads: Sequence[torch.Tensor],
                  applies: bool) -> None:
        """The device half of G's update, then the EMA."""
        self._updating = True
        self.g_opt.device_update(grads, applies)
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.g_params,
                                alpha=1.0 - self.ema_decay)

    def _slice_batch(self, batch: Dict[str, torch.Tensor], step: int
                     ) -> Dict[str, torch.Tensor]:
        """``_window`` of ``batch`` with step ``step``'s offsets."""
        self._offsets.manual_seed(self._noise_seed(step, _OFFSETS))
        return self._window(batch)

    def _window(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """A random window per row of the device-resident full waveform
        (at the vocoder's rate, ``upsample`` samples a frame): offsets in
        [0, max(mel_len - seg_frames, 0)], drawn on the device from
        ``_offsets`` as the host seeded it (over the global batch on a
        mesh, then this rank's rows)."""
        mel_len = batch["mel_lengths"]
        max_off = torch.clamp(mel_len - self.seg_frames, min=0)
        index, count = ((0, 1) if self.mesh is None
                        else pmesh.batch_sharding(self.mesh))
        u = pmesh.rows(torch.rand((count * mel_len.shape[0],),
                                  generator=self._offsets,
                                  device=mel_len.device), index, count)
        offsets = torch.floor(u * (max_off + 1).float()).to(torch.int32)
        audio = _f32(batch["audio"])
        S = self.seg_frames * self.upsample
        start = (offsets.long() * self.upsample).clamp(
            max=audio.shape[1] - S)
        cols = start[:, None] + torch.arange(S, device=start.device)
        out = {k: v for k, v in batch.items() if k != "audio"}
        out["frame_offsets"] = offsets
        out["audio_seg"] = torch.gather(audio, 1, cols)
        return out

    # -- steps -------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One GAN step on a device batch (or a host batch, prepared and
        copied here): the host half (seeds, ramp, the optimizers' branches,
        lrs and divisors), then the device half (``_step_fn``) as a replay
        of its graph where ``_graphed``, else eagerly, then the counts.
        Returns the losses as device scalars; nothing waits for the
        device."""
        if isinstance(batch.get("mel"), np.ndarray):
            batch = self._transfer.transfer(_rows(
                batch if "audio_seg" in batch else self._prepare(batch),
                self.mesh))
        tensors = {k: v for k, v in batch.items()
                   if isinstance(v, torch.Tensor)}
        seed = self._noise_seed(self.step, _DROPOUT)
        self._noise_d.manual_seed(seed)
        self._noise_g.manual_seed(seed)
        generators = [self._noise_d, self._noise_g]
        if "audio" in tensors:  # device-cached: the window is cut inside
            self._offsets.manual_seed(self._noise_seed(self.step, _OFFSETS))
            generators.append(self._offsets)
        # None: that net sits this step out (alternate_gd)
        d_applies = g_applies = None
        if not self.alternate_gd or self.step % 2 == 0:
            d_applies = self.d_opt.begin_update()
        if not self.alternate_gd or self.step % 2 == 1:
            if self.adv_warmup > 0:
                self._ramp.fill_(self._ramp_value())
            g_applies = self.g_opt.begin_update()
        keys = tuple(tensors)
        fn = functools.partial(self._step_fn, keys, d_applies, g_applies)
        if self._graphed():
            self._drop_stale_graphs()
            self._updating = True  # a bucket's first call updates eagerly
            metrics = self._graphs(("step", keys, d_applies, g_applies), fn,
                                   *tensors.values(), generators=generators)
        else:
            metrics = fn(*tensors.values())
        if d_applies is not None:
            self.d_opt.end_update(d_applies)
            self.d_updates += 1
        if g_applies is not None:
            self.g_opt.end_update(g_applies)
            self.g_updates += 1
        self.step += 1
        return metrics

    def _step_fn(self, keys: Tuple[str, ...], d_applies: Optional[bool],
                 g_applies: Optional[bool], *tensors: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        """The device half of a GAN step on the batch's tensors (named by
        ``keys``): what a step graph holds. The D step (its loss,
        gradients and guarded update) unless ``d_applies`` is None, then
        the G step (losses, gradients, update, EMA) unless ``g_applies``
        is None; each ``*_applies`` tells that optimizer's device half
        whether to apply."""
        batch = _upcast(dict(zip(keys, tensors)))
        if "audio" in batch:  # device-cached: the window is cut here
            batch = self._window(batch)
        metrics: Dict[str, torch.Tensor] = {}
        if d_applies is not None:
            d_loss, grads = self._d_loss_and_grads(batch)
            self._d_update(grads, d_loss, d_applies)
            metrics["discriminator_loss"] = d_loss
        if g_applies is not None:
            losses, grads = self._g_loss_and_grads(
                batch, metrics.get("discriminator_loss"))
            self._g_update(grads, g_applies)
            metrics.update(losses)
        return metrics

    def _ramp_value(self) -> float:
        """The adversarial warmup ramp of the next G update, as JAX traces
        it: ``clip(f32(g_state.step) / adv_warmup, 0, 1)`` in f32."""
        return float(np.clip(np.float32(self.g_updates)
                             / np.float32(self.adv_warmup), 0.0, 1.0))

    def _graphed(self) -> bool:
        """Whether a step (and validation's forward) is one graph replay:
        on CUDA without a mesh or on an NCCL mesh, outside
        ``disable_graphs()``."""
        return self._graphs is not None and self._graphs.active()

    def _drop_stale_graphs(self) -> None:
        loads = (self.g_opt.loads, self.d_opt.loads)
        if loads != self._graph_loads:
            self._graphs.drop()  # the optimizers' state tensors are new
            self._graph_loads = loads

    def _guarded_step(self, batch) -> Optional[Dict[str, torch.Tensor]]:
        """One step; None after an out-of-memory error, recovered: the step
        is dropped, and when an update had begun the last host snapshot is
        restored."""
        self._updating = False
        try:
            return self.train_step(batch)
        except torch.cuda.OutOfMemoryError:
            if self.mesh is not None:  # the other ranks wait in a collective
                raise
            self._clear_cache()
            if self._updating:
                logger.error("OOM in an update at step %d — restoring the "
                             "last snapshot (step %d)", self.step,
                             self._oom_snapshot[1])
                self._restore_snapshot(self._oom_snapshot)
            else:
                logger.error("OOM at step %d before any update; step "
                             "dropped", self.step)
            return None

    # -- data --------------------------------------------------------------
    def _prepare(self, batch: Dict[str, np.ndarray],
                 rng: Optional[np.random.Generator] = None,
                 return_targets: bool = False):
        """Host batch → host batch with ``frame_offsets`` and
        ``audio_seg`` in place of ``audio``. ``rng`` defaults to the
        training segment stream; validation passes its own."""
        offsets, targets = _segment_audio(
            batch["audio"], batch["mel_lengths"], self.seg_frames, self.hop,
            self.upsample, rng if rng is not None else self._host_rng)
        host = {k: v for k, v in batch.items() if k != "audio"}
        host["frame_offsets"] = offsets
        host["audio_seg"] = targets
        return (host, targets) if return_targets else host

    def _stage_audio(self, audio: np.ndarray, frames_bucket: int
                     ) -> np.ndarray:
        """Host, once per staged batch: full waveforms at the vocoder's
        effective rate, ``frames_bucket * upsample`` samples long."""
        want = frames_bucket * self.upsample
        if self.upsample != self.hop:
            from math import gcd

            from scipy.signal import resample_poly

            g = gcd(self.upsample, self.hop)
            audio = np.stack([
                resample_poly(row, self.upsample // g, self.hop // g)
                .astype(np.float32) for row in audio])
        out = np.zeros((audio.shape[0], want), np.float32)
        n = min(want, audio.shape[1])
        out[:, :n] = audio[:, :n]
        return out

    def _device_cached_iterator(self):
        """Infinite iterator over device-resident batches carrying whole
        waveforms (one copy each, ever), reshuffled each epoch; None when
        the staged bytes would exceed the budget."""
        from m2tts_tpu_torch.data.device_cache import (epoch_shuffled,
                                                       stage_on_device)

        def put(b):
            b = dict(b, audio=self._stage_audio(b["audio"], b["mel"].shape[1]))
            return self._transfer.transfer(_rows(b, self.mesh))

        staged = stage_on_device(
            make_batches(self.dataset, self.batch_size, self.buckets,
                         seed=self.seed, shuffle=True, drop_last=False,
                         audio_samples=self._max_audio_samples()),
            put, self.device_cache_max_gb * 1e9)
        return epoch_shuffled(staged, self.seed + 17) if staged else None

    def _max_audio_samples(self) -> int:
        return max(m for _, m in self.buckets) * self.hop

    def _effective_sample_rate(self) -> int:
        """The vocoder's output rate: data.sample_rate scaled by
        upsample / hop."""
        sr = int(self.config.get("data.sample_rate", 22050))
        return int(sr * self.upsample / self.hop)

    # -- loop --------------------------------------------------------------
    def train(self, resume: bool = False) -> Dict[str, float]:
        if resume and self.ckpt.latest_step() is not None:
            self.restore()
        it = self._device_cached_iterator() if self.device_data_cache else None
        if it is None:
            source = data_iterator(self.dataset, self.batch_size,
                                   self.buckets, seed=self.seed,
                                   audio_samples=self._max_audio_samples())
            depth = int(self.config.get("data.prefetch", 2))
            source = (_rows(self._prepare(b), self.mesh) for b in source)
            it = (DevicePrefetcher(
                source, self._transfer.put, depth,
                ready_fn=self._transfer.ready) if depth > 0
                else map(self._transfer.transfer, source))
        last: Dict[str, float] = {}
        t_last = time.perf_counter()
        try:
            while self.step < self.max_steps:
                if not self.thermal.check():
                    self.thermal.wait_for_cooldown()
                batch = next(it)
                with self.profiler.step(self.step):
                    metrics = self._guarded_step(batch)
                if metrics is None:
                    continue
                if self.step % self.log_every == 0:
                    # the one host read of the interval
                    values = dict(zip(metrics, torch.stack(
                        list(metrics.values())).tolist()))
                    if not all(math.isfinite(v) for v in values.values()):
                        self._recover_after_blowup()
                        t_last = time.perf_counter()
                        continue
                    now = time.perf_counter()
                    values["steps_per_sec"] = self.log_every / (now - t_last)
                    t_last = now
                    values.update(self.memory.update())
                    self.metrics.log(values, self.step)
                    logger.info("step %d: %s", self.step,
                                {k: round(v, 4) for k, v in values.items()})
                    last = values
                ran_quality_pass = False
                if self.step % self.validate_every == 0:
                    val = self.validate()
                    ran_quality_pass = self.validate_quality
                    self.metrics.log({f"val_{k}": v for k, v in val.items()},
                                     self.step)
                    score = val.get(self._gate_metric_name())
                    if score is not None:
                        if score < self.best_val_score:
                            self.best_val_score = score
                            self.save_best_checkpoint(score)
                        if self.early_stopping(score):
                            logger.info("Early stopping at step %d",
                                        self.step)
                            break
                if (self.generate_samples_every
                        and self.step % self.generate_samples_every == 0
                        and not ran_quality_pass):
                    params = self._eval_params()
                    if self.is_main:
                        self.sample_validator.run(params, self.step)
                if self.step % self.save_every == 0:
                    self.save_checkpoint()
        except KeyboardInterrupt:
            logger.info("Interrupted at step %d — saving", self.step)
        finally:
            if hasattr(it, "close"):
                it.close()
            self.profiler.close(self.step - 1)
            self.save_checkpoint()
            self.metrics.close()
        return last

    # -- validation --------------------------------------------------------
    @torch.no_grad()
    def _val_fwd(self, batch: Dict[str, torch.Tensor],
                 params: Dict[str, torch.Tensor]):
        """Teacher-forced eval-mode forward of the scored weights
        ``params``: (mel loss, MR-STFT loss at its default phase weight,
        mel, audio); a replay of the bucket's graph where ``_graphed``,
        with ``params`` among its inputs (copied in at every call, so it
        scores the weights of the call)."""
        tensors = {k: v for k, v in batch.items()
                   if isinstance(v, torch.Tensor)}
        keys, names = tuple(tensors), tuple(params)
        fn = functools.partial(self._val_fn, keys, names)
        args = (*tensors.values(), *params.values())
        if self._graphed():
            return self._graphs(("val", keys, names), fn, *args)
        return fn(*args)

    def _val_fn(self, keys: Tuple[str, ...], names: Tuple[str, ...],
                *tensors: torch.Tensor):
        batch = _upcast(dict(zip(keys, tensors)))
        params = dict(zip(names, tensors[len(keys):]))
        self._eval_model.eval()
        try:
            _, mel_pred, audio_pred = self._acoustic_and_segment(
                params, batch, self._eval_model)
        finally:
            self._eval_model.train()
        mel_loss = L.masked_mel_l1(mel_pred, batch["mel"],
                                   batch["mel_lengths"])
        spec_loss = L.multi_resolution_stft_loss(audio_pred,
                                                 batch["audio_seg"])
        return mel_loss, spec_loss, mel_pred, audio_pred

    def validate(self, n_batches: int = 2) -> Dict[str, float]:
        """Losses and the quality composite on held-out batches, and with
        ``validate_quality`` the evaluator sweep, full-utterance STOI/LSD
        (``utt_`` keys) and the sample validator. Deterministic: segments
        come from a fresh ``default_rng(seed + 7777)``, so validating
        neither jitters the metric nor advances the training stream. On a
        mesh rank 0 validates the gathered weights and every rank gets its
        metrics.

        ``quality_score`` = segment MCD + spectral convergence;
        ``quality_score_audio`` adds ``gate_stoi_weight · (1 − utt_stoi)``.
        """
        params = self._eval_params()
        if self.mesh is None:
            return self._validate(params, n_batches)
        return pmesh.broadcast_object(
            self._validate(params, n_batches) if self.is_main else None)

    def _validate(self, params: Dict[str, torch.Tensor],
                  n_batches: int) -> Dict[str, float]:
        from m2tts_tpu_torch.evaluation.metrics import (
            compute_mcd, compute_spectral_convergence)
        from m2tts_tpu_torch.evaluation.stoi import compute_stoi

        it = make_batches(self.dataset, self.batch_size, self.buckets,
                          seed=0, shuffle=False, drop_last=False,
                          audio_samples=self._max_audio_samples())
        val_rng = np.random.default_rng(self.seed + 7777)
        totals: Dict[str, float] = {}
        mcds: list = []
        sconvs: list = []
        stois: list = []
        count = 0
        sr = self._effective_sample_rate()
        for batch in it:
            n_valid = int(batch.get("n_valid", batch["mel"].shape[0]))
            host, seg_targets = self._prepare(batch, rng=val_rng,
                                              return_targets=True)
            mel_loss, spec_loss, mel_pred, audio_pred = self._val_fwd(
                self._transfer.transfer(host), params)
            mel_loss, spec_loss = torch.stack([mel_loss, spec_loss]).tolist()
            mel_pred_h = mel_pred.cpu().numpy()
            audio_pred_h = audio_pred.cpu().numpy()
            totals["mel_loss"] = totals.get("mel_loss", 0.0) + mel_loss
            totals["spectral_loss"] = totals.get(
                "spectral_loss", 0.0) + spec_loss
            for i in range(n_valid):  # duplicates of padded batches excluded
                n = int(batch["mel_lengths"][i])
                if n > 0:
                    mcds.append(compute_mcd(mel_pred_h[i, :n].T,
                                            batch["mel"][i, :n].T))
                sconvs.append(compute_spectral_convergence(
                    audio_pred_h[i], seg_targets[i]))
                s = compute_stoi(seg_targets[i], audio_pred_h[i], sr)
                if np.isfinite(s):
                    stois.append(s)
            count += 1
            if count >= n_batches:
                break
        out = {k: v / max(count, 1) for k, v in totals.items()}
        if mcds:
            out["mcd"] = float(np.mean(mcds))
        if sconvs:
            out["spectral_convergence"] = float(np.mean(sconvs))
        if stois:
            out["stoi"] = float(np.mean(stois))
        if mcds or sconvs:
            out["quality_score"] = (out.get("mcd", 0.0)
                                    + out.get("spectral_convergence", 0.0))
        if self.validate_quality:
            out.update(self._quality_metrics(params, n_batches))
            if (self.gate_stoi_weight > 0 and "utt_stoi" in out
                    and "quality_score" in out):
                out["quality_score_audio"] = (
                    out["quality_score"]
                    + self.gate_stoi_weight * (1.0 - out["utt_stoi"]))
        return out

    def _quality_metrics(self, params: Dict[str, torch.Tensor],
                         n_batches: int) -> Dict[str, float]:
        """Evaluator sweep, full-utterance teacher-forced audio metrics
        (STOI, LSD, spectral convergence; ``utt_`` keys) and the eval-text
        samples with their MOS, all on the scored weights ``params``."""
        from m2tts_tpu_torch.evaluation.metrics import (
            benchmark_audio_quality, benchmark_model_performance)

        out: Dict[str, float] = {}
        sr = int(self.config.get("data.sample_rate", 22050))
        try:
            batches = make_batches(self.dataset, self.batch_size,
                                   self.buckets, seed=0, shuffle=False,
                                   drop_last=False)
            out.update(benchmark_model_performance(
                self._eval_model, params, batches,
                num_samples=self.batch_size * n_batches,
                sample_rate=sr, _fn_cache=self._bm_cache))
        except Exception:  # a failed sweep must not stop training
            logger.warning("benchmark_model_performance failed",
                           exc_info=True)
        try:
            batches = make_batches(self.dataset, self.batch_size,
                                   self.buckets, seed=0, shuffle=False,
                                   drop_last=False,
                                   audio_samples=self._max_audio_samples())
            aq = benchmark_audio_quality(
                self._eval_model, params, batches,
                num_samples=self.quality_utterances, sample_rate=sr,
                hop_length=self.hop, _fn_cache=self._bm_cache)
            out.update({k: v for k, v in {
                "utt_stoi": aq.get("stoi"),
                "utt_lsd": aq.get("log_spectral_distance"),
                "utt_spectral_convergence": aq.get("spectral_convergence"),
            }.items() if v is not None})
        except Exception:  # a failed pass skips the gate this round
            logger.warning("benchmark_audio_quality failed", exc_info=True)
        out.update(self.sample_validator.run(params, self.step))
        return out

    @property
    def sample_validator(self):
        if self._sample_validator is None:
            from m2tts_tpu_torch.training.validation import \
                validator_from_config

            self._sample_validator = validator_from_config(
                self.config, build_model(self.config.get("model", Config())),
                stage=2, device=self.device)
        return self._sample_validator

    def _gate_metric_name(self) -> str:
        """The validate() key that drives early stopping and ``best/``."""
        if not self.validate_quality:
            return "mel_loss"
        return ("quality_score_audio" if self.gate_stoi_weight > 0
                else "quality_score")

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self) -> None:
        if self.step == 0:
            return
        state = self._host_state()
        # a blow-up between log steps must never reach the latest
        # checkpoint or the rewind snapshot
        if not tree_finite((state["generator"], state["discriminator"])):
            logger.error("Refusing to checkpoint non-finite params at step "
                         "%d (blow-up not yet detected)", self.step)
            return
        self._oom_snapshot = (state, self.step, self.g_updates,
                              self.d_updates)
        if self.is_main:
            self.ckpt.save(self.step, state, config=self.config)

    def save_best_checkpoint(self, score: float) -> None:
        """Pin the current state under ``<ckpt_dir>/best``: the raw
        generator with its own optimizer state (so a resume never pairs
        EMA weights with raw Adam moments) and the EMA, which the gate
        scored and ``from_checkpoint(dir, step="best")`` serves."""
        state = self._host_state()
        if not self.is_main:
            return
        if self._best_ckpt is None:
            self._best_ckpt = CheckpointManager(
                self.ckpt.directory / "best", max_to_keep=1)
        self._best_ckpt.save(self.step, state, config=self.config,
                             metrics={"val_score": float(score)})
        _write_best_score(self.ckpt.directory, self.step, score,
                          metric=self._gate_metric_name())
        logger.info("New best validation score %.6f at step %d", score,
                    self.step)

    def restore(self) -> None:
        """Resume the latest checkpoint: both nets, both optimizers, the
        step, the EMA and the best score with its metric. A checkpoint
        whose stored keys lack ``generator_ema`` (written with EMA off), or
        whose keys cannot be read, seeds the EMA from the restored
        generator; a checkpoint that cannot be loaded raises."""
        stored = self.ckpt.state_keys()
        state, _, step = self.ckpt.restore()
        ema = None
        if self.ema is not None:
            if stored is not None and "generator_ema" in stored:
                ema = state["generator_ema"]
            else:
                logger.warning(
                    "Checkpoint step %d: %s — the EMA starts from the "
                    "restored generator", step,
                    "its keys could not be read, so it is restored without "
                    "generator_ema" if stored is None
                    else "no generator_ema (written with EMA off)")
                ema = state["generator"]
        self._load_state(state, ema)
        # as the JAX package's restore sets each TrainState.step
        self.step = self.g_updates = self.d_updates = step
        self._oom_snapshot = self._snapshot()
        self.best_val_score = _read_best_score(
            self.ckpt.directory, self.best_val_score,
            metric=self._gate_metric_name())
        logger.info("Resumed stage-2 from step %d", step)

    def close(self):
        self.ckpt.close()
        if self._best_ckpt is not None:
            self._best_ckpt.close()
        self.metrics.close()
