"""The PyTorch port stands alone: importing every module of
``m2tts_tpu_torch`` and everything ``chip_smoke.py`` imports loads no JAX,
no flax and no module of the JAX package; the entry points default to CUDA
and raise without it; ``chip_smoke.py`` fails without a CUDA device and
without the rest of the repo."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from m2tts_tpu_torch.models.tts_model import M2TTS
from m2tts_tpu_torch.serving import pipeline
from m2tts_tpu_torch.training import train
from m2tts_tpu_torch.training.trainer import Stage1Trainer
from m2tts_tpu_torch.utils.config import FLAGSHIP_MODEL, Config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "m2tts_tpu")

_CHILD = r"""
import ast, json, pkgutil, importlib, sys
sys.path.insert(0, ROOT)
import m2tts_tpu_torch
names = [m.name for m in pkgutil.walk_packages(m2tts_tpu_torch.__path__,
                                               "m2tts_tpu_torch.")]
for n in names:
    importlib.import_module(n)
tree = ast.parse(open(ROOT + "/chip_smoke.py").read())
smoke = set()
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        smoke.update(a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom):
        smoke.add(node.module)
for n in sorted(smoke):
    importlib.import_module(n)
print(json.dumps({"imported": names, "smoke": sorted(smoke),
                  "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]  # whole names: m2tts_tpu_torch is not m2tts_tpu
    return top in FORBIDDEN


def test_no_jax_or_reference_package_imported():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {str(ROOT)!r}\n" + _CHILD],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "m2tts_tpu_torch.serving.pipeline" in report["imported"]
    assert "m2tts_tpu_torch.ops.cuda.vocoder" in report["imported"]
    for name in ("serving.server", "serving.streaming", "serving.batcher",
                 "serving.stream_batcher", "utils.checkpoint",
                 "training.trainer", "training.train", "data.dataset",
                 "data.prefetch", "utils.torch_compat"):
        assert f"m2tts_tpu_torch.{name}" in report["imported"]
    assert "m2tts_tpu_torch.serving" in report["smoke"]
    bad = [m for m in report["modules"] if _forbidden(m)]
    assert not bad, bad
    assert not any(_forbidden(m) for m in report["smoke"])


def test_forbidden_matches_whole_names():
    assert _forbidden("m2tts_tpu") and _forbidden("m2tts_tpu.models")
    assert not _forbidden("m2tts_tpu_torch")
    assert not _forbidden("m2tts_tpu_torch.ops.cuda")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        pipeline.from_config(FLAGSHIP_MODEL)
    model = M2TTS(hidden_dim=16, mel_channels=8, vocoder_channels=16,
                  text_encoder_layers=1, decoder_layers=1)
    with pytest.raises(RuntimeError):
        pipeline.Synthesizer(model)
    with pytest.raises(RuntimeError):
        Stage1Trainer(Config({"model": FLAGSHIP_MODEL}))
    with pytest.raises(RuntimeError):
        pipeline.from_torch_checkpoint("reference.pt")
    with pytest.raises(RuntimeError):
        train.main(["training.max_steps=1"])  # the CLI's default device


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_imports_are_declared():
    """chip_smoke.py names the port's modules it needs, and no others."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert any(m.startswith("m2tts_tpu_torch") for m in mods)
    assert not any(_forbidden(m) for m in mods if m)
