"""Deployable serving artifacts: ``torch.export`` synthesis graphs.

Counterpart of ``m2tts_tpu/serving/export.py``. ``export_synthesizer``
writes the serving pipeline's graphs (``torch.export`` programs, saved
with ``torch.export.save``) plus the weights and a JSON manifest into one
directory; ``ExportedSynthesizer`` loads that directory and synthesizes
without the model's Python code: only the host-side text frontend, the
bucket helpers of ``serving/pipeline.py`` and the PyTorch runtime.

Artifact layout::

    manifest.json             buckets, dtypes, rates, file index
    params.npz                weights, '/'-joined state-dict paths as keys
    graphs/synth_b{B}_t{T}_f{F}.pt2   (weights, [B,T+1] i32 packed ids +
                                      lengths, f32 0-d scale) →
                                      {pcm: int16 [B, F·U], total_frames}
    graphs/probe_b{B}_t{T}.pt2        (weights, packed, scale) → total
                                      frames [B], per (B, T)

The weights are graph inputs: no program lifts a parameter or buffer (its
``state_dict`` is empty), so ``params.npz`` is the one copy of them, as in
the JAX artifact. Under ``compute_dtype='bf16'`` the synthesis graph casts
its f32 weight inputs to bf16, as the JAX graph does; the probe runs in
f32.

The graphs use the port's ``torch`` vocoder backend (the ``Vocoder``
module), as the JAX artifact uses its pure-XLA vocoder: the hand-written
CUDA kernels are launched through ctypes, which ``torch.export`` cannot
record, and stay the live ``Synthesizer``'s serving path for the same
function.

Devices: each graph is traced once, on the synthesizer's device
(``traced_device`` in the manifest). A traced graph records that device in
the ops that make tensors (``torch.arange(..., device=...)``), so a load
on another device of ``platforms`` rewrites them with
``torch.export.passes.move_to_device_pass`` (``device_move`` in the
manifest).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from m2tts_tpu_torch.utils.device import resolve_device

MANIFEST_NAME = "manifest.json"
ARTIFACT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
DEVICE_MOVE = "torch.export.passes.move_to_device_pass"


def _flatten(state_dict) -> Iterator[Tuple[str, np.ndarray]]:
    for k in sorted(state_dict):
        yield k.replace(".", "/"), state_dict[k].detach().cpu().numpy()


def _unflatten(pairs) -> Dict[str, torch.Tensor]:
    return {k.replace("/", "."): torch.from_numpy(np.array(v))
            for k, v in sorted(pairs)}


class _Call(torch.nn.Module):
    """``fn(model, ids, lengths, scale)`` as a module's forward, so
    ``torch.func.functional_call`` can run it on other weights."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model, self._fn = model, fn

    def forward(self, ids, lengths, scale):
        return self._fn(self.model, ids, lengths, scale)


class _Graph(torch.nn.Module):
    """``fn(model, ids, lengths, scale)`` with the model's weights as the
    first input (cast to ``cast`` when given). The model is held outside
    the module tree, so the exported program lifts none of its weights."""

    def __init__(self, model: torch.nn.Module, fn, cast=None):
        super().__init__()
        self.__dict__["_call"] = _Call(model, fn)  # not a submodule
        self._cast = cast

    def forward(self, params: Dict[str, torch.Tensor], packed: torch.Tensor,
                scale: torch.Tensor):
        if self._cast is not None:
            params = {k: v.to(self._cast) if v.is_floating_point() else v
                      for k, v in params.items()}
        return torch.func.functional_call(
            self._call, {f"model.{k}": v for k, v in params.items()},
            (packed[:, :-1], packed[:, -1], scale))


def _synth_fn(max_frames: int):
    from m2tts_tpu_torch.serving.pipeline import quantize_pcm16

    def fn(model, ids, lengths, scale):
        out = model.synthesize(ids, lengths, duration_scale=scale,
                               max_frames=max_frames)
        return {"pcm": quantize_pcm16(out["audio_output"][..., 0]),
                "total_frames": out["total_frames"]}

    return fn


def _platforms(platforms: Optional[Sequence[str]],
               device: torch.device) -> List[str]:
    out = list(platforms) if platforms else [device.type]
    bad = [p for p in out if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}; expected a subset of "
                         f"{PLATFORMS}")
    return out


def export_synthesizer(synth, out_dir: Union[str, Path],
                       full: bool = False,
                       platforms: Optional[Sequence[str]] = None) -> Dict:
    """Write a deployable artifact for ``synth`` to ``out_dir``.

    ``full=False`` exports the single-stream path (smallest batch bucket
    × every text/frame bucket); ``full=True`` exports every reachable
    (batch, text, frame) combination. ``platforms`` (e.g.
    ``("cuda", "cpu")``) names the devices the artifact must load on;
    default is the synthesizer's device. Returns the manifest dict."""
    from m2tts_tpu_torch.serving.pipeline import probe_frames

    device = synth.device
    platforms = _platforms(platforms, device)
    model = synth.model.eval()
    out = Path(out_dir)
    (out / "graphs").mkdir(parents=True, exist_ok=True)
    state = model.state_dict()
    np.savez(out / "params.npz", **dict(_flatten(state)))
    params = {k: state[k] for k in sorted(state)}
    scale = torch.tensor(1.0, dtype=torch.float32, device=device)
    cast = torch.bfloat16 if synth.compute_dtype == "bf16" else None

    def save(fn, packed, name, cast=None):
        ep = torch.export.export(_Graph(model, fn, cast).eval(),
                                 (params, packed, scale), strict=False)
        if ep.state_dict:
            raise RuntimeError(f"{name} lifted weights: {list(ep.state_dict)}")
        # the example inputs hold the weights: params.npz is their one copy
        ep.example_inputs = None
        torch.export.save(ep, out / name)

    graphs: List[Dict] = []
    probes: List[Dict] = []
    seen_bt = set()
    with torch.no_grad():
        for b, t, f in synth.reachable_shapes(full):
            packed = torch.zeros((b, t + 1), dtype=torch.int32, device=device)
            packed[:, -1] = 1
            name = f"graphs/synth_b{b}_t{t}_f{f}.pt2"
            save(_synth_fn(f), packed, name, cast)
            graphs.append({"batch": b, "text": t, "frames": f, "file": name})
            if (b, t) not in seen_bt:
                seen_bt.add((b, t))
                pname = f"graphs/probe_b{b}_t{t}.pt2"
                save(probe_frames, packed, pname)
                probes.append({"batch": b, "text": t, "file": pname})

    manifest = {
        "artifact_version": ARTIFACT_VERSION,
        "platforms": platforms,
        "sample_rate": synth.sample_rate,
        "upsample": synth.upsample,
        "compute_dtype": synth.compute_dtype,
        "text_buckets": list(synth.text_buckets),
        "frame_buckets": list(synth.frame_buckets),
        "batch_buckets": sorted({g["batch"] for g in graphs}),
        "params_file": "params.npz",
        # the artifact must pronounce exactly like the synthesizer it was
        # exported from: custom lexicon entries travel in the manifest
        "extra_lexicon": {k: list(v)
                          for k, v in synth.extra_lexicon.items()},
        "graphs": graphs,
        "probes": probes,
        "traced_device": device.type,
        "device_move": DEVICE_MOVE,
    }
    (out / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
    return manifest


class ExportedSynthesizer:
    """Run synthesis from an exported artifact directory on ``device``
    (CUDA by default; raises without it, as every entry point of the
    port does).

    Needs only the artifact, the text frontend (``frontend/text.py``) and
    ``encode_packed_batch``/``_bucket_for``; instantiates no model.
    Mirrors the Synthesizer's host logic: bucket selection, duration probe,
    packed ids+lengths transfer, one device→host fetch, per-utterance PCM
    trim."""

    def __init__(self, path: Union[str, Path], device="cuda"):
        from m2tts_tpu_torch.frontend.text import TextProcessor

        self.device = resolve_device(device)
        self.dir = Path(path)
        self.manifest = json.loads((self.dir / MANIFEST_NAME).read_text())
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(
                f"artifact exported for {self.manifest['platforms']}, not "
                f"{self.device.type}; export with --platforms "
                f"{','.join(self.manifest['platforms'] + [self.device.type])}")
        with np.load(self.dir / self.manifest["params_file"]) as z:
            self.params = {k: v.to(self.device) for k, v in
                           _unflatten((k, z[k]) for k in z.files).items()}
        self.sample_rate = int(self.manifest["sample_rate"])
        self.upsample = int(self.manifest["upsample"])
        self.text_buckets = tuple(self.manifest["text_buckets"])
        self.frame_buckets = tuple(self.manifest["frame_buckets"])
        self.batch_buckets = tuple(self.manifest["batch_buckets"])
        self.text_processor = TextProcessor(
            extra_lexicon=self.manifest.get("extra_lexicon") or None)
        self._graphs = {(g["batch"], g["text"], g["frames"]): g["file"]
                        for g in self.manifest["graphs"]}
        self._probes = {(p["batch"], p["text"]): p["file"]
                        for p in self.manifest["probes"]}
        self._loaded: Dict[str, torch.nn.Module] = {}

    def _program(self, file: str) -> torch.nn.Module:
        if file not in self._loaded:
            ep = torch.export.load(self.dir / file)
            if self.device.type != self.manifest["traced_device"]:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, self.device)
            self._loaded[file] = ep.module()
        return self._loaded[file]

    @torch.no_grad()
    def _call(self, file: str, packed: torch.Tensor, scale: torch.Tensor):
        return self._program(file)(self.params, packed, scale)

    def synthesize_batch(self, texts: List[str],
                         duration_scale: float = 1.0
                         ) -> List[Dict[str, np.ndarray]]:
        # the same host-side encoding and bucketing the graphs were traced
        # against: shared code, so the convention cannot desynchronize
        from m2tts_tpu_torch.serving.pipeline import (_bucket_for,
                                                      encode_packed_batch)

        packed = torch.from_numpy(encode_packed_batch(
            self.text_processor, texts, self.batch_buckets,
            self.text_buckets)).to(self.device)
        scale = torch.tensor(duration_scale, dtype=torch.float32,
                             device=self.device)
        b, t = packed.shape[0], packed.shape[1] - 1
        totals = self._call(self._probes[(b, t)], packed, scale).cpu().numpy()
        frames = _bucket_for(int(totals[: len(texts)].max()),
                             self.frame_buckets)
        out = self._call(self._graphs[(b, t, frames)], packed, scale)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        pcm, tf = host["pcm"], host["total_frames"]
        results = []
        for i in range(len(texts)):
            n_frames = int(min(tf[i], frames))
            audio_pcm = pcm[i, : n_frames * self.upsample]
            results.append({
                "audio_pcm": audio_pcm,
                "audio": audio_pcm.astype(np.float32) / 32767.0,
                "frames": n_frames,
            })
        return results

    def synthesize(self, text: str, duration_scale: float = 1.0
                   ) -> Dict[str, np.ndarray]:
        return self.synthesize_batch([text], duration_scale)[0]
