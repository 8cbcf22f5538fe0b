"""The multi-device dry run of the port: one stage-2 step on a mesh, the
sharded ``Synthesizer`` against the single-device one, and a streaming
chunk.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (``:58-199``),
which self-provisions a mesh of virtual CPU devices. Here a mesh is one
process per rank: called inside a process group of ``n`` ranks (every rank
calls it), the run uses that group; otherwise it spawns ``n`` ranks
(``parallel.mesh.spawn_world``) and returns rank 0's summary.

    python -c "from m2tts_tpu_torch.parallel.dryrun import dryrun_multichip; \\
        dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def dryrun_config(n_devices: int, out_dir: str):
    """The JAX dry run's config: a 32-wide, one-layer, two-head generator
    with a 32-channel vocoder, one segment of 2048 samples a row, batch
    max(n, 4), the mesh (n/2 × 2) from 4 devices up and (n × 1) below."""
    from m2tts_tpu_torch.utils.config import Config

    model_axis = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    batch = max(n_devices, 4)
    return Config({
        "model": {
            "text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                             "num_layers": 1, "num_heads": 2, "dropout": 0.1},
            "decoder": {"mel_channels": 8, "num_layers": 1},
            "vocoder": {"hidden_channels": 32,
                        "upsample_rates": [8, 8, 2, 2]},
        },
        "training": {"batch_size": batch, "max_steps": 1, "bf16": False,
                     "learning_rate": 1e-4, "warmup_steps": 0,
                     "lr_scheduler": "constant", "audio_segment_len": 2048,
                     "log_every": 1, "save_every": 10**9,
                     "validate_every": 10**9, "seed": 0},
        "data": {"buckets": [[48, 128]], "n_mels": 8, "hop_length": 256},
        "system": {"mesh": {"data": n_devices // model_axis,
                            "model": model_axis},
                   "log_metrics": "jsonl"},
        "paths": {"output_dir": out_dir,
                  "checkpoint_dir": f"{out_dir}/ckpt",
                  "log_dir": f"{out_dir}/logs"},
    })


def _dryrun(n_devices: int, device, out_dir: str) -> Dict[str, Any]:
    """One rank's part: the stage-2 step, the sharded batch against the
    single-device batch (frames equal, PCM within 1 LSB), a finite
    streaming chunk on the trained weights."""
    from m2tts_tpu_torch.data.dataset import DummyDataset, data_iterator
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.parallel.mesh import make_mesh
    from m2tts_tpu_torch.parallel.partition import full_tree
    from m2tts_tpu_torch.serving.pipeline import Synthesizer
    from m2tts_tpu_torch.serving.streaming import StreamingSynthesizer
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    device = torch.device(device)
    cfg = dryrun_config(n_devices, out_dir)
    mesh = make_mesh(cfg.get("system.mesh.data"), cfg.get("system.mesh.model"),
                     device_type=device.type)
    batch = int(cfg.get("training.batch_size"))
    ds = DummyDataset(size=4 * batch, mel_dim=8, max_text_length=40,
                      max_mel_length=120, seed=0, keep_audio=True)
    trainer = Stage2Trainer(cfg, dataset=ds, device=device, mesh=mesh)
    it = data_iterator(ds, batch, trainer.buckets, seed=0,
                       audio_samples=trainer._max_audio_samples())
    metrics = {k: float(v) for k, v in trainer.train_step(next(it)).items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite stage-2 metrics {metrics}")
    params = full_tree({n: p.detach() for n, p in zip(trainer.g_names,
                                                      trainer.g_params)})
    trainer.close()

    def model():
        m = build_model(cfg.get("model"))
        m.load_state_dict(params)
        return m

    texts = ["hello world from the mesh"] * batch
    kw = dict(text_buckets=(16,), frame_buckets=(64,),
              batch_buckets=(batch,), vocoder_backend="torch",
              compute_dtype="f32", device=device)
    sharded = Synthesizer(model(), mesh=mesh, **kw)
    single = Synthesizer(model(), **kw)
    # duration_scale stretches the near-zero random-init durations, so the
    # comparison covers more than a frame or two
    out_s = sharded.synthesize_batch(texts, duration_scale=16.0,
                                     max_frames=64)
    out_1 = single.synthesize_batch(texts, duration_scale=16.0,
                                    max_frames=64)
    frames = [r["frames"] for r in out_s]
    if frames != [r["frames"] for r in out_1] or frames[0] <= 0:
        raise RuntimeError(f"sharded frames {frames} differ from the single "
                           f"device's {[r['frames'] for r in out_1]}")
    lsb = max(int(np.abs(a["audio_pcm"].astype(np.int32)
                         - b["audio_pcm"]).max(initial=0))
              for a, b in zip(out_s, out_1))
    if lsb > 1:
        raise RuntimeError(f"sharded PCM {lsb} LSB from the single device's")
    ss = StreamingSynthesizer(single.model, chunk_frames=16, max_frames=64,
                              text_bucket=16, vocoder_backend="torch",
                              compute_dtype="f32", device=device)
    chunk = np.asarray(next(iter(ss.stream(texts[0]))), np.float32)
    if not np.isfinite(chunk).all():
        raise RuntimeError("non-finite streaming chunk")
    return {"mesh": list(mesh.mesh.shape), "metrics": metrics,
            "frames": frames[0], "max_pcm_lsb": lsb,
            "stream_chunk_shape": list(chunk.shape)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict[str, Any]:
    """The dry run on ``n_devices`` ranks; returns (and logs) rank 0's
    summary. In a process group of ``n_devices`` ranks every rank runs its
    part here; otherwise ``n_devices`` ranks are spawned on ``device``
    (NCCL on CUDA, one card a rank; gloo on the CPU)."""
    import tempfile

    from m2tts_tpu_torch.parallel.mesh import spawn_world

    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        if dist.is_initialized():
            if dist.get_world_size() != n_devices:
                raise ValueError(f"dryrun_multichip({n_devices}) in a world "
                                 f"of {dist.get_world_size()} ranks")
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if torch.device(device).type == "cuda" else device)
            out = _dryrun(n_devices, dev, out_dir)
        else:
            out = spawn_world(_spawned, n_devices,
                              args=(n_devices, torch.device(device).type,
                                    out_dir),
                              device=device)[0]
    logger.info("dryrun_multichip(%d) OK: %s", n_devices, out)
    return out


def _spawned(n_devices: int, device_type: str, out_dir: str
             ) -> Dict[str, Any]:
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    return _dryrun(n_devices, device, out_dir)
