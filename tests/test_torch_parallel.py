"""Multi-device training of the PyTorch port (``parallel/``, the mesh paths
of ``training/trainer.py`` and ``trainer_stage2.py``) against the JAX
package, on the CPU.

Each world is two gloo ranks spawned by ``parallel.mesh.spawn_world``
(``file://`` rendezvous in ``tmp_path``, one torch thread a rank); the
ranks import no JAX and return their results, which the parent holds
against the JAX references it computes on the conftest's virtual CPU
devices. Sizes as ``tests/test_tp.py``: 32-d, one layer each, two heads,
8 mel bins, batch 8.

- the TP rules on the port's parameter names mark the same tensors as the
  JAX rules on the flax paths, and place them as stated;
- stage-1 steps on (2, 1) and (1, 2) meshes against the JAX ``Stage1Trainer``
  on ``make_mesh(data=2)`` (dropout 0, weights by ``from_flax``): losses within rtol 2e-4 / atol 2e-5, the
  weights after three updates within ``PARAMS_ATOL`` (the bar of
  ``tests/test_torch_train.py``), and (2, 1) against (1, 2) as
  ``test_tp.py`` holds them;
- with dropout 0.1 the (2, 1) and (1, 2) steps equal the single-device step
  (every layout draws the same global masks) to the same bars;
- the head-split attention and the column/row FFN against the unsharded
  modules (outputs and input gradients within 1e-6), the TP global norm
  against the unsharded one;
- a (1, 2) run's checkpoint resumes in a single-device trainer to the
  gathered weights and serves at 0 LSB from them;
- on (1, 2) under accumulation (k = 2, three micro-steps) every optimizer
  state tensor (Adam's moments and step counts, the accumulator) and the
  tensors the optimizer updates are plain tensors sharing the DTensor
  parameters' storage, and ``state_dict()`` gathers to the global moments
  and accumulator of the same steps on one device;
- one stage-2 step at (2, 1) against the single-device step;
- ``dryrun_multichip(2)`` on the CPU; ``get_device_info`` reports the rank
  and world size.
"""

from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

from m2tts_tpu_torch.data.dataset import DummyDataset
from m2tts_tpu_torch.parallel import mesh as pmesh
from m2tts_tpu_torch.parallel import partition
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.utils.config import Config

torch.set_num_threads(2)

DS_KW = dict(size=64, mel_dim=8, max_text_length=40, max_mel_length=120,
             seed=0)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_tp.py
PARAMS_ATOL = 1e-6  # tests/test_torch_train.py, f32 after three updates
MESHES = {"dp": {"data": 2, "model": 1}, "tp": {"data": 1, "model": 2}}


def tiny_config(out, dropout=0.0, mesh=None, **training):
    """tests/test_torch_train.py's tiny config on ``mesh``."""
    t = {"batch_size": 8, "max_steps": 6, "learning_rate": 1e-3,
         "warmup_steps": 2, "gradient_clip_norm": 1.0, "bf16": False,
         "log_every": 2, "save_every": 100, "validate_every": 100,
         "max_checkpoints": 2, "seed": 0, "validate_samples": False}
    t.update(training)
    return {
        "model": {
            "text_encoder": {"vocab_size": 64, "hidden_dim": 32,
                             "num_layers": 1, "num_heads": 2,
                             "dropout": dropout},
            "decoder": {"mel_channels": 8, "num_layers": 1},
            "vocoder": {"hidden_channels": 32},
        },
        "training": t,
        "data": {"buckets": [[48, 128]], "n_mels": 8},
        "system": {"mesh": mesh or {"data": -1}, "log_metrics": "jsonl"},
        "paths": {"output_dir": f"{out}/out",
                  "checkpoint_dir": f"{out}/out/ckpt",
                  "log_dir": f"{out}/out/logs"},
    }


def _steps(trainer, weights, batches):
    """Load the global ``weights``, run one step a batch; (losses per step,
    the gathered weights)."""
    with torch.no_grad():
        params = weights if trainer.mesh is None else \
            partition.shard_tree(weights, trainer.mesh)
        trainer.model.load_state_dict(params)
    losses = [{k: v.item() for k, v in trainer._train_step(
        trainer._put(b)).items()} for b in batches]
    return losses, trainer._host_state_copy()["params"]


# -- what the ranks run (no JAX) --------------------------------------------

def _stage1_world(out, weights, batches):
    from m2tts_tpu_torch.models.components import (FeedForward,
                                                   MultiHeadSelfAttention)
    from m2tts_tpu_torch.utils.device import get_device_info

    res = {"info": {k: get_device_info()[k]
                    for k in ("process_index", "process_count")}}
    for name, axes in MESHES.items():
        for dropout in (0.0, 0.1):
            t = Stage1Trainer(Config(tiny_config(f"{out}/{name}{dropout}",
                                                 dropout, axes)),
                              dataset=DummyDataset(**DS_KW), device="cpu")
            res[name, dropout] = _steps(t, weights, batches)
            if name == "tp" and dropout == 0.0:
                res["placements"] = {
                    n: (repr(p.placements[0]), tuple(p.to_local().shape))
                    for n, p in t.model.named_parameters()}
            t.close()

    # the TP blocks against the unsharded ones, forward and backward
    mesh = pmesh.make_mesh(1, 2, device_type="cpu")
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 12, 32, generator=gen)
    mask = torch.arange(12)[None] < torch.tensor([12, 7, 3, 0])[:, None]
    blocks = {}
    for key, make, call in (
            ("attn", lambda: MultiHeadSelfAttention(32, 2, 0.0),
             lambda m, x: m(x, mask)),
            ("ffn", lambda: FeedForward(32, 64, 0.0), lambda m, x: m(x))):
        # the model's paths (``...attn.qkv.weight``) pick the rules; the
        # same seed on both ranks
        torch.manual_seed(0)
        plain = torch.nn.ModuleDict({key: make()})
        tp = partition.local_module(partition.shard_module(
            torch.nn.ModuleDict({key: make()}), mesh))
        assert tp[key].tp_group is not None
        tp.load_state_dict(partition.local_tree(
            partition.shard_tree(plain.state_dict(), mesh)))
        xs = [x.clone().requires_grad_() for _ in range(2)]
        ys = [call(plain[key], xs[0]), call(tp[key], xs[1])]
        gs = [torch.autograd.grad(y.square().sum(), xi)[0]
              for y, xi in zip(ys, xs)]
        blocks[key] = ((ys[0] - ys[1]).abs().max().item(),
                       (gs[0] - gs[1]).abs().max().item())
    res["blocks"] = blocks

    # the global norm of a TP gradient against the unsharded norm
    full = {"ffn.fc1.weight": torch.randn(64, 32, generator=gen),
            "attn.qkv.weight": torch.randn(96, 32, generator=gen),
            "norm.scale": torch.randn(32, generator=gen)}
    placed = list(partition.shard_tree(full, mesh).values())
    res["norm"] = (partition.global_norm(placed).item(),
                   torch.linalg.vector_norm(torch.cat(
                       [v.reshape(-1) for v in full.values()])).item())

    # (1, 2) under accumulation: what the optimizer holds, what it gathers to
    t = Stage1Trainer(Config(tiny_config(f"{out}/tp_acc", 0.0, MESHES["tp"],
                                         gradient_accumulation_steps=2)),
                      dataset=DummyDataset(**DS_KW), device="cpu")
    _steps(t, weights, batches)
    opt = t.optimizer
    state = [v for st in opt.adamw.state.values() for v in st.values()]
    shares = [p.data_ptr() == q.to_local().data_ptr()
              for p, q in zip(opt.params, opt.placed)]
    res["tp_acc"] = {
        "plain": [type(x) is torch.Tensor or type(x) is torch.nn.Parameter
                  for x in state + opt.acc + opt.params],
        "n_state": len(state), "shares_storage": all(shares),
        "sharded": sum(isinstance(p, partition.DTensor) and p.placements[
            0].is_shard() for p in opt.placed),
        "gathered": partition.full_tree({k: opt.state_dict()[k] for k in (
            "mu", "nu", "acc_grads")})}
    t.close()

    # a (1, 2) run that checkpoints; its gathered in-memory weights
    cfg = tiny_config(f"{out}/ckpt_run", 0.1, MESHES["tp"], max_steps=2,
                      save_every=2)
    t = Stage1Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                      device="cpu")
    t.train()
    res["ckpt"] = (t.ckpt.directory, t._host_state_copy())
    t.close()
    return res


def _stage2_world(out, cfg):
    from m2tts_tpu_torch.parallel.dryrun import dryrun_multichip
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    t = Stage2Trainer(Config(cfg), dataset=DummyDataset(**S2_DS_KW),
                      device="cpu")
    step = _stage2_step(t)
    t.close()
    return {"stage2": step, "dryrun": dryrun_multichip(2, device="cpu")}


# -- stage 2 ------------------------------------------------------------------

S2_DS_KW = dict(DS_KW, keep_audio=True)


def stage2_config(out):
    """tests/test_torch_stage2_step.py's tiny config with both guards, the
    envelope loss and EMA on; dropout 0.1."""
    cfg = tiny_config(out, 0.1, MESHES["dp"], warmup_steps=0,
                      lr_scheduler="constant", audio_segment_len=512,
                      stft_phase_weight=0.0, adaptive_d_lr_floor=2.0,
                      adaptive_adv_dloss_floor=2.0, ema_decay=0.5,
                      envelope_loss_weight=1.0, adversarial_warmup_steps=2)
    cfg["data"]["hop_length"] = 256
    return cfg


def _stage2_step(trainer):
    """Two fused steps on the seeded host batches: (metrics per step, the
    gathered generator, discriminator and EMA)."""
    from m2tts_tpu_torch.data.dataset import data_iterator

    it = data_iterator(trainer.dataset, 8, trainer.buckets, seed=0,
                       audio_samples=trainer._max_audio_samples())
    metrics = [{k: v.item() for k, v in trainer.train_step(next(it)).items()}
               for _ in range(2)]
    state = trainer._host_state()
    return metrics, {k: state[k] for k in ("generator", "discriminator",
                                           "generator_ema")}


# -- the parent's references and the worlds ---------------------------------

@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """JAX's mesh steps, the port's single-device steps, and the stage-1
    world's results."""
    import jax

    from m2tts_tpu.data.dataset import DummyDataset as JaxDummyDataset
    from m2tts_tpu.data.dataset import make_batches as jax_make_batches
    from m2tts_tpu.parallel.mesh import make_mesh
    from m2tts_tpu.training.trainer import Stage1Trainer as JaxTrainer
    from m2tts_tpu.utils.config import Config as JaxConfig
    from m2tts_tpu_torch.utils.params import from_flax

    tmp = tmp_path_factory.mktemp("stage1")
    jt = JaxTrainer(JaxConfig(tiny_config(f"{tmp}/jax", 0.0,
                                          MESHES["dp"])),
                    dataset=JaxDummyDataset(**DS_KW),
                    mesh=make_mesh(data=2, devices=jax.devices()[:2]))
    weights = from_flax(jax.device_get(jt.state.params))
    batches = list(jax_make_batches(JaxDummyDataset(**DS_KW), 8, jt.buckets,
                                    seed=5))[:3]
    state, losses = jt.state, []
    for b in batches:
        state, jl = jt._train_step(state, jt._put(b), jax.random.PRNGKey(0))
        losses.append({k: float(v) for k, v in jl.items()})
    jax_run = (losses, from_flax(jax.device_get(state.params)))
    jt.close()
    plain = {}
    for dropout in (0.0, 0.1):
        t = Stage1Trainer(Config(tiny_config(f"{tmp}/plain{dropout}",
                                             dropout)),
                          dataset=DummyDataset(**DS_KW), device="cpu")
        plain[dropout] = _steps(t, weights, batches)
        t.close()
    t = Stage1Trainer(Config(tiny_config(f"{tmp}/plain_acc", 0.0,
                                         gradient_accumulation_steps=2)),
                      dataset=DummyDataset(**DS_KW), device="cpu")
    _steps(t, weights, batches)
    sd = t.optimizer.state_dict()
    plain["acc"] = {k: sd[k] for k in ("mu", "nu", "acc_grads")}
    t.close()
    world = pmesh.spawn_world(_stage1_world, 2,
                              args=(str(tmp / "world"), weights, batches),
                              workdir=str(tmp))
    return {"jax": jax_run, "plain": plain, "world": world}


def _assert_losses(got, want, tol=LOSS_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("mel_loss", "duration_loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def _assert_params(got, want, atol=PARAMS_ATOL):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=atol, msg=k)


def test_partition_rules_mark_the_jax_tensors():
    """The port's rules shard exactly the tensors the JAX rules shard (the
    flax kernel ``[in, out]`` is the torch weight ``[out, in]``: column is
    Shard(0), row Shard(1); the fused QKV splits heads on its (3, H, H)
    view); norms, convs and everything else replicate."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from m2tts_tpu.models import M2TTS as JaxM2TTS
    from m2tts_tpu.parallel.partition import partition_specs as jax_specs
    from m2tts_tpu_torch.models.tts_model import M2TTS

    kw = dict(hidden_dim=32, mel_channels=8, vocoder_channels=16,
              text_encoder_layers=1, decoder_layers=1)
    params = jax.eval_shape(partial(JaxM2TTS(**kw).init, max_frames=16,
                                    run_vocoder=True),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_specs(params), is_leaf=lambda x: isinstance(x, P))[0]
    want = {".".join(k.key for k in path).replace("kernel", "weight")
            for path, spec in leaves if spec != P()}
    specs = partition.partition_specs(dict(M2TTS(**kw).named_parameters()))
    assert {k for k, s in specs.items() if s.is_shard()} == want
    enc = "text_encoder.layer0."
    assert specs[enc + "attn.qkv.weight"] == partition.Shard(1)
    assert specs[enc + "attn.out.weight"] == partition.Shard(1)
    assert specs[enc + "ffn.fc1.weight"] == partition.Shard(0)
    assert specs[enc + "ffn.fc1.bias"] == partition.Shard(0)
    assert specs[enc + "ffn.fc2.weight"] == partition.Shard(1)
    assert specs[enc + "norm1.weight"] == partition.Replicate()
    assert specs["vocoder.input_conv.conv.weight"] == partition.Replicate()


def test_setup_devices_without_a_process_group():
    from m2tts_tpu_torch.utils.device import get_device_info, setup_devices

    assert setup_devices("cpu") == [torch.device("cpu")]
    info = get_device_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    if not torch.cuda.is_available():
        assert setup_devices() == [torch.device("cpu")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            setup_devices("cuda")


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(2)


def test_placement_on_the_model_axis(stage1):
    """(1, 2): each rank holds whole heads (the (3, H, H) QKV view split on
    heads), half the FFN columns; everything else whole."""
    for rank in stage1["world"]:
        pl = rank["placements"]
        enc = "text_encoder.layer0."
        assert pl[enc + "attn.qkv.weight"] == ("Shard(dim=1)", (3, 16, 32))
        assert pl[enc + "attn.out.weight"] == ("Shard(dim=1)", (32, 16))
        assert pl[enc + "ffn.fc1.weight"] == ("Shard(dim=0)", (32, 32))
        assert pl[enc + "ffn.fc1.bias"] == ("Shard(dim=0)", (32,))
        assert pl[enc + "ffn.fc2.weight"] == ("Shard(dim=1)", (32, 32))
        assert pl[enc + "ffn.fc2.bias"] == ("Replicate()", (32,))
        assert pl["decoder.mel_proj.weight"] == ("Replicate()", (8, 32))
        assert rank["info"] == {"process_index": stage1["world"].index(rank),
                                "process_count": 2}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_step_matches_jax(stage1, name):
    """Both layouts against JAX's step on ``make_mesh(data=2)``."""
    jax_losses, jax_params = stage1["jax"]
    for rank in stage1["world"]:
        losses, params = rank[name, 0.0]
        _assert_losses(losses, jax_losses)
        _assert_params(params, jax_params)


def test_tp_step_matches_dp_step(stage1):
    """A (1, 2) step equals a (2, 1) step: TP is a layout, not numerics."""
    dp, tp = stage1["world"][0]["dp", 0.0], stage1["world"][0]["tp", 0.0]
    _assert_losses(tp[0], dp[0])
    _assert_params(tp[1], dp[1])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_dropout_on_a_mesh_equals_one_device(stage1, name):
    losses, params = stage1["plain"][0.1]
    for rank in stage1["world"]:
        _assert_losses(rank[name, 0.1][0], losses)
        _assert_params(rank[name, 0.1][1], params)
    # and the masks are live: dropout moved the losses
    assert losses[0]["total_loss"] != stage1["plain"][0.0][0][0]["total_loss"]


@pytest.mark.parametrize("block", ["attn", "ffn"])
def test_tp_blocks_match_unsharded(stage1, block):
    for rank in stage1["world"]:
        out_err, grad_err = rank["blocks"][block]
        assert out_err < 1e-6 and grad_err < 1e-6


def test_tp_global_norm_is_the_unsharded_norm(stage1):
    for rank in stage1["world"]:
        got, want = rank["norm"]
        assert got == pytest.approx(want, rel=1e-6)


def test_tp_checkpoint_resumes_and_serves_on_one_device(stage1, tmp_path):
    """The (1, 2) run's checkpoint holds the global weights: a single-device
    trainer resumes to the ranks' gathered weights and optimizer moments,
    and ``from_checkpoint`` serves at 0 LSB from a Synthesizer on them."""
    from m2tts_tpu_torch.models.tts_model import build_model
    from m2tts_tpu_torch.serving import pipeline

    ckdir, gathered = stage1["world"][0]["ckpt"]
    for rank in stage1["world"][1:]:
        _assert_params(rank["ckpt"][1]["params"], gathered["params"], atol=0)
    cfg = tiny_config(str(tmp_path), 0.1, max_steps=2)
    cfg["paths"]["checkpoint_dir"] = str(ckdir)
    t = Stage1Trainer(Config(cfg), dataset=DummyDataset(**DS_KW),
                      device="cpu")
    t.train(resume=True)
    assert t.step == 2
    _assert_params(t._host_state_copy()["params"], gathered["params"],
                   atol=0)
    for key in ("mu", "nu"):
        _assert_params(t.optimizer.state_dict()[key],
                       gathered["opt_state"][key], atol=0)
    t.close()
    buckets = dict(text_buckets=(16, 32), frame_buckets=(64,),
                   batch_buckets=(4,))
    served = pipeline.from_checkpoint(ckdir, device="cpu", **buckets)
    model = build_model(Config(cfg).get("model"))
    model.load_state_dict(gathered["params"])
    ref = pipeline.Synthesizer(model, device="cpu", **buckets)
    texts = ["hello world", "the quick brown fox", "a"]
    for a, b in zip(served.synthesize_batch(texts, duration_scale=12.0),
                    ref.synthesize_batch(texts, duration_scale=12.0)):
        assert a["frames"] == b["frames"] > 0
        np.testing.assert_array_equal(a["audio_pcm"], b["audio_pcm"])


def test_tp_optimizer_state_is_local_and_gathers_to_one_device(stage1):
    """(1, 2), k = 2, three micro-steps: plain tensors in the optimizer,
    sharing the parameters' storage; the moments and the accumulator
    gathered equal one device's within the weights' bar."""
    want = stage1["plain"]["acc"]
    for rank in stage1["world"]:
        got = rank["tp_acc"]
        assert all(got["plain"]) and got["n_state"] > 0
        # five in each transformer layer: the encoder's and the decoder's
        assert got["shares_storage"] and got["sharded"] == 10
        for key in ("mu", "nu", "acc_grads"):
            assert want[key]
            _assert_params(got["gathered"][key], want[key])


# -- stage 2 and the dry run --------------------------------------------------

@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    from m2tts_tpu_torch.training.trainer_stage2 import Stage2Trainer

    tmp = tmp_path_factory.mktemp("stage2")
    cfg = stage2_config(str(tmp / "plain"))
    cfg["system"]["mesh"] = {"data": -1}
    t = Stage2Trainer(Config(cfg), dataset=DummyDataset(**S2_DS_KW),
                      device="cpu")
    plain = _stage2_step(t)
    t.close()
    world = pmesh.spawn_world(_stage2_world, 2,
                              args=(str(tmp / "world"),
                                    stage2_config(str(tmp / "world"))),
                              workdir=str(tmp))
    return plain, world


# two GAN steps at lr 1e-3 in f32: the losses within the stage-1 bar; the
# weights within lr/100 (the second step's Adam update of a near-zero
# gradient moves with its rounding, as in tests/test_torch_stage2_step.py)
S2_PARAMS_ATOL = 1e-5


def test_stage2_step_on_a_data_mesh_equals_one_device(stage2):
    (plain_metrics, plain_state), world = stage2
    for rank in world:
        metrics, state = rank["stage2"]
        for got, want in zip(metrics, plain_metrics):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **LOSS_TOL)
        for key in plain_state:
            _assert_params(state[key], plain_state[key], S2_PARAMS_ATOL)


def test_dryrun_multichip_on_the_cpu(stage2):
    _, world = stage2
    out = world[0]["dryrun"]
    assert out["mesh"] == [2, 1] and out["frames"] > 0
    assert out["max_pcm_lsb"] <= 1 and out["stream_chunk_shape"]
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert world[1]["dryrun"]["metrics"] == out["metrics"]
