"""Reference PyTorch checkpoints in the port (``utils/torch_compat.py``,
``pipeline.from_torch_checkpoint``) against the JAX package's loader. The
test writes the reference-layout ``.pt`` files itself (no reference
checkpoint ships with the repo): JAX-initialised ``duration_norm='batch'``
params with seeded BatchNorm statistics, under the reference's key names,
with a plain-dict config embedded. Both converters give the same param
tree exactly (and the inverse used to write the file is exact against the
JAX converter), also at 5 upsample stages; the JAX ``xla`` Synthesizer and
the port's (CPU, ``torch`` backend) give the same frames and PCM within
±1 LSB."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.models import build_model as jax_build_model
from m2tts_tpu.serving import pipeline as jpipeline
from m2tts_tpu.utils import torch_compat as jcompat
from m2tts_tpu.utils.config import Config as JaxConfig
from m2tts_tpu_torch.models.tts_model import build_model
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.utils import torch_compat as tcompat
from m2tts_tpu_torch.utils.params import from_flax, to_flax

torch.set_num_threads(2)

BUCKETS = dict(text_buckets=(16, 32), frame_buckets=(64, 128),
               batch_buckets=(1, 4))
TEXTS = ["hello world", "the quick brown fox jumps", "a test"]
SCALE = 12.0


def reference_config(rates=(4, 4, 2, 2), channels=32):
    return {"model": {
        "text_encoder": {"vocab_size": 256, "hidden_dim": 32,
                         "num_layers": 1, "num_heads": 2, "dropout": 0.0},
        "decoder": {"mel_channels": 16, "num_layers": 2},
        "vocoder": {"hidden_channels": channels,
                    "upsample_rates": list(rates)}},
        "data": {"sample_rate": 16000, "hop_length": 64}}


def jax_params(cfg, seed=0):
    """JAX-initialised params of the batch-norm model, with seeded
    BatchNorm statistics so the fold is exercised."""
    model_cfg = JaxConfig(cfg).model
    model_cfg.set("duration_predictor.norm", "batch")
    model = jax_build_model(model_cfg)
    params = jax.device_get(jax.jit(partial(
        model.init, max_frames=16, run_vocoder=True))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)
    pred = params["duration_predictor"]["predictor"]
    for block in ("block1", "block2"):
        n = pred[block]["bn_mean"].shape
        pred[block] = {**pred[block],
                       "bn_mean": rng.normal(0, 0.1, n).astype(np.float32),
                       "bn_var": rng.uniform(0.5, 2.0, n).astype(np.float32),
                       "bn_scale": rng.normal(1, 0.1, n).astype(np.float32),
                       "bn_bias": rng.normal(0, 0.1, n).astype(np.float32)}
    return params


def write_reference_pt(path, cfg, params):
    m = cfg["model"]
    sd = tcompat.reference_state_dict(
        params, m["text_encoder"]["num_layers"], m["decoder"]["num_layers"],
        len(m["vocoder"]["upsample_rates"]))
    torch.save({"model_state_dict": sd, "config": cfg, "epoch": 3}, path)
    return sd


def _trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("rates,channels", [((4, 4, 2, 2), 32),
                                            ((2, 2, 2, 2, 2), 64)],
                         ids=["4_stages", "5_stages"])
def test_converters_agree_exactly(tmp_path, rates, channels):
    cfg = reference_config(rates, channels)
    params = jax_params(cfg)
    sd = write_reference_pt(tmp_path / "ref.pt", cfg, params)
    assert "duration_predictor.predictor.conv_layers.1.norm.running_var" in sd
    assert f"vocoder.upsamples.{len(rates) - 1}.weight" in sd
    jtree, jcfg = jcompat.convert_reference_checkpoint(str(tmp_path / "ref.pt"))
    ttree, tcfg = tcompat.convert_reference_checkpoint(tmp_path / "ref.pt")
    assert jcfg == tcfg == cfg
    _trees_equal(ttree, jtree)
    _trees_equal(ttree, params)  # the file's writer inverts JAX's reader
    state = from_flax(ttree)
    model_cfg = dict(cfg["model"], duration_predictor={"norm": "batch"})
    model = build_model(model_cfg)
    model.load_state_dict(state, strict=True)
    assert len(model.upsample_rates) == len(rates)
    # a port model's own weights round-trip through the reference layout
    back = tcompat.convert_reference_state_dict(
        tcompat.reference_state_dict(to_flax(model.state_dict()), 1, 2,
                                     len(rates)), 1, 2, len(rates))
    for k, v in from_flax(back).items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_from_torch_checkpoint_matches_jax(tmp_path):
    cfg = reference_config()
    write_reference_pt(tmp_path / "ref.pt", cfg, jax_params(cfg, seed=1))
    js = jpipeline.from_torch_checkpoint(str(tmp_path / "ref.pt"),
                                         vocoder_backend="xla", **BUCKETS)
    ts = pipeline.from_torch_checkpoint(tmp_path / "ref.pt", device="cpu",
                                        **BUCKETS)
    assert ts.vocoder_backend == "torch" and ts.device.type == "cpu"
    assert (ts.sample_rate, ts.hop_length) == (16000, 64)
    assert ts.config.get("model.duration_predictor.norm") == "batch"
    assert ts.model.duration_predictor.predictor.block1.norm_kind == "batch"
    for r, o in zip(js.synthesize_batch(TEXTS, SCALE),
                    ts.synthesize_batch(TEXTS, SCALE)):
        assert r["frames"] == o["frames"] > 0
        assert np.abs(r["audio_pcm"].astype(np.int32)
                      - o["audio_pcm"]).max(initial=0) <= 1


def test_from_torch_checkpoint_defaults_to_cuda(tmp_path):
    cfg = reference_config()
    model = build_model(dict(cfg["model"], duration_predictor={"norm": "batch"}))
    write_reference_pt(tmp_path / "ref.pt", cfg, to_flax(model.state_dict()))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.from_torch_checkpoint(tmp_path / "ref.pt")
