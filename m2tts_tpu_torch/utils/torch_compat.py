"""Reference PyTorch checkpoints (the original m2-tts layout) → the port.

A copy of ``m2tts_tpu/utils/torch_compat.py:26-158``: the converter writes
the flax-layout param tree that the JAX package's converter writes (equal
exactly), and ``utils.params.from_flax`` turns it into the port's state
dict. Layouts:

- torch Linear weight (out, in)        → Dense kernel (in, out)
- torch Conv1d weight (out, in/g, k)   → Conv kernel (k, in/g, out)
- torch ConvTranspose1d (in, out, k)   → ConvTranspose1d kernel (in, out, k)
- torch BatchNorm1d running stats      → ConvBlock(norm='batch') affine fold

so converted models are built with ``duration_norm='batch'``.
``reference_state_dict`` is the inverse: a flax-layout tree back to the
reference's key names and layouts.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    """torch tensor → float32 numpy."""
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _dense(sd: Mapping, prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _conv1d(sd: Mapping, prefix: str) -> Dict[str, Dict[str, np.ndarray]]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return {"conv": out}


def _conv_transpose1d(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _transformer_layer(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {
        "attn": {
            "qkv": _dense(sd, f"{prefix}.self_attn.qkv", bias=False),
            "out": _dense(sd, f"{prefix}.self_attn.out_proj"),
        },
        "ffn": {
            "fc1": _dense(sd, f"{prefix}.ffn.linear1"),
            "fc2": _dense(sd, f"{prefix}.ffn.linear2"),
        },
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
    }


def _conv_block_batchnorm(sd: Mapping, prefix: str) -> Dict[str, Any]:
    """Reference ConvBlock (conv + BatchNorm1d) → ConvBlock(norm='batch')."""
    return {
        "conv1d": _conv1d(sd, f"{prefix}.conv"),
        "bn_scale": _np(sd[f"{prefix}.norm.weight"]),
        "bn_bias": _np(sd[f"{prefix}.norm.bias"]),
        "bn_mean": _np(sd[f"{prefix}.norm.running_mean"]),
        "bn_var": _np(sd[f"{prefix}.norm.running_var"]),
    }


def _resblock(sd: Mapping, prefix: str) -> Dict[str, Any]:
    return {"conv1": _conv1d(sd, f"{prefix}.conv1"),
            "conv2": _conv1d(sd, f"{prefix}.conv2")}


def convert_reference_state_dict(sd: Mapping, text_encoder_layers: int = 2,
                                 decoder_layers: int = 2,
                                 num_upsamples: int = 4) -> Dict[str, Any]:
    """Reference M2TTSModel state_dict → flax-layout param tree (nested
    dicts of numpy arrays, the tree ``utils.params.from_flax`` takes)."""
    text_encoder: Dict[str, Any] = {
        "embedding": {"embedding": _np(sd["text_encoder.embedding.weight"])},
        "norm": _layernorm(sd, "text_encoder.norm"),
    }
    for i in range(text_encoder_layers):
        text_encoder[f"layer{i}"] = _transformer_layer(sd, f"text_encoder.layers.{i}")

    duration_predictor = {
        "predictor": {
            "block1": _conv_block_batchnorm(sd, "duration_predictor.predictor.conv_layers.0"),
            "block2": _conv_block_batchnorm(sd, "duration_predictor.predictor.conv_layers.1"),
            "proj": _conv1d(sd, "duration_predictor.predictor.projection"),
        }
    }

    decoder: Dict[str, Any] = {
        "norm": _layernorm(sd, "decoder.norm"),
        "mel_proj": _dense(sd, "decoder.mel_projection"),
    }
    for i in range(decoder_layers):
        decoder[f"layer{i}"] = _transformer_layer(sd, f"decoder.layers.{i}")

    vocoder: Dict[str, Any] = {
        "input_conv": _conv1d(sd, "vocoder.input_conv"),
        "output_conv": _conv1d(sd, "vocoder.output_conv"),
    }
    for i in range(num_upsamples):
        vocoder[f"upsample{i}"] = _conv_transpose1d(sd, f"vocoder.upsamples.{i}")
        vocoder[f"resblock{i}"] = _resblock(sd, f"vocoder.resblocks.{i}")

    return {
        "text_encoder": text_encoder,
        "duration_predictor": duration_predictor,
        "decoder": decoder,
        "vocoder": vocoder,
    }


def convert_reference_checkpoint(path: str):
    """Load a reference torch checkpoint file → (flax-layout params, config).

    The reference embeds its config object in every checkpoint, so the
    file is read with ``weights_only=False``, as the JAX package reads it:
    load only files you trust. The config sizes the layer and upsample
    loops and is returned for rebuilding the model.
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model_state_dict"] if "model_state_dict" in ckpt else ckpt
    cfg = ckpt.get("config", {}) if isinstance(ckpt, dict) else {}

    def _cfg_get(path_: str, default):
        node = cfg
        for part in path_.split("."):
            try:
                node = node[part]
            except Exception:
                return default
        return node

    n_enc = int(_cfg_get("model.text_encoder.num_layers", 2))
    n_dec = int(_cfg_get("model.decoder.num_layers", 2))
    # size the vocoder loop from the embedded config too — a checkpoint
    # with e.g. 5 upsample stages would otherwise be silently converted
    # as 4 and fail (or mis-run) far from the real cause
    rates = _cfg_get("model.vocoder.upsample_rates", None)
    n_ups = len(rates) if rates is not None else 4
    params = convert_reference_state_dict(sd, n_enc, n_dec,
                                          num_upsamples=n_ups)
    return params, cfg


def reference_state_dict(params: Mapping, text_encoder_layers: int,
                         decoder_layers: int, num_upsamples: int
                         ) -> Dict[str, torch.Tensor]:
    """Flax-layout params of a ``duration_norm='batch'`` model → the
    reference's state dict (the inverse of ``convert_reference_state_dict``;
    ``utils.params.to_flax`` gives the tree of a port model)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, a):
        sd[key] = torch.tensor(np.asarray(a, np.float32))

    def dense(prefix, p, bias=True):
        put(f"{prefix}.weight", np.asarray(p["kernel"]).T)
        if bias:
            put(f"{prefix}.bias", p["bias"])

    def norm(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    def conv(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["conv"]["kernel"]).transpose(2, 1, 0))
        if "bias" in p["conv"]:
            put(f"{prefix}.bias", p["conv"]["bias"])

    def layer(prefix, p):
        dense(f"{prefix}.self_attn.qkv", p["attn"]["qkv"], bias=False)
        dense(f"{prefix}.self_attn.out_proj", p["attn"]["out"])
        dense(f"{prefix}.ffn.linear1", p["ffn"]["fc1"])
        dense(f"{prefix}.ffn.linear2", p["ffn"]["fc2"])
        norm(f"{prefix}.norm1", p["norm1"])
        norm(f"{prefix}.norm2", p["norm2"])

    te = params["text_encoder"]
    put("text_encoder.embedding.weight", te["embedding"]["embedding"])
    norm("text_encoder.norm", te["norm"])
    for i in range(text_encoder_layers):
        layer(f"text_encoder.layers.{i}", te[f"layer{i}"])
    pred = params["duration_predictor"]["predictor"]
    for i, name in enumerate(("block1", "block2")):
        prefix = f"duration_predictor.predictor.conv_layers.{i}"
        conv(f"{prefix}.conv", pred[name]["conv1d"])
        put(f"{prefix}.norm.weight", pred[name]["bn_scale"])
        put(f"{prefix}.norm.bias", pred[name]["bn_bias"])
        put(f"{prefix}.norm.running_mean", pred[name]["bn_mean"])
        put(f"{prefix}.norm.running_var", pred[name]["bn_var"])
    conv("duration_predictor.predictor.projection", pred["proj"])
    dec = params["decoder"]
    norm("decoder.norm", dec["norm"])
    dense("decoder.mel_projection", dec["mel_proj"])
    for i in range(decoder_layers):
        layer(f"decoder.layers.{i}", dec[f"layer{i}"])
    voc = params["vocoder"]
    conv("vocoder.input_conv", voc["input_conv"])
    conv("vocoder.output_conv", voc["output_conv"])
    for i in range(num_upsamples):
        put(f"vocoder.upsamples.{i}.weight", voc[f"upsample{i}"]["kernel"])
        put(f"vocoder.upsamples.{i}.bias", voc[f"upsample{i}"]["bias"])
        conv(f"vocoder.resblocks.{i}.conv1", voc[f"resblock{i}"]["conv1"])
        conv(f"vocoder.resblocks.{i}.conv2", voc[f"resblock{i}"]["conv2"])
    return sd
