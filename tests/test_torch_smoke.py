"""The port's pipeline smoke suite (``m2tts_tpu_torch/smoke.py``) and what it
reads, on the CPU:

- ``main(["--cpu"])`` in this process passes all seven parts and returns
  0; ``--quick`` skips inference + WAV (six parts);
- its parts carry the names of ``scripts/test_pipeline.py``'s
  ``ALL_PARTS``, in the same order (read with ``ast``: the JAX script is
  not run);
- ``frontend.text.write_phoneme_dict`` writes the JAX function's bytes;
- ``utils.config.load_config``, which the "config loading" part calls,
  reads every ``configs/*.yaml`` as the JAX package's ``load_config`` does.
"""

import ast
from pathlib import Path

import pytest
import torch

from m2tts_tpu.frontend.text import write_phoneme_dict as jax_write
from m2tts_tpu.utils.config import load_config as jax_load_config
from m2tts_tpu_torch import smoke
from m2tts_tpu_torch.frontend.text import write_phoneme_dict
from m2tts_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("argv,parts", [(["--cpu"], 7),
                                        (["--cpu", "--quick"], 6)])
def test_smoke_suite_passes_on_the_cpu(capsys, argv, parts):
    assert smoke.main(argv) == 0
    out = capsys.readouterr().out
    assert f"{parts}/{parts} parts passed" in out
    assert "[FAIL]" not in out
    assert ("[ OK ] inference + WAV" in out) == (parts == 7)


def _jax_part_names():
    tree = ast.parse((ROOT / "scripts" / "test_pipeline.py").read_text())
    names = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            for d in node.decorator_list:
                if isinstance(d, ast.Call) and getattr(d.func, "id",
                                                       "") == "_part":
                    names[node.name] = d.args[0].value
    parts = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "ALL_PARTS")
    return [names[e.id] for e in parts.elts]


def test_parts_match_the_jax_suite():
    want = _jax_part_names()
    assert len(want) == 7
    assert [f._part_name for f in smoke.ALL_PARTS] == want
    assert [f.__name__ for f in smoke.ALL_PARTS] == [
        "test_device", "test_text", "test_phoneme_dict", "test_model_forward",
        "test_inference_wav", "test_dataset", "test_config"]


def test_write_phoneme_dict_matches_jax(tmp_path):
    write_phoneme_dict(tmp_path / "port" / "phonemes.tsv")
    jax_write(tmp_path / "jax" / "phonemes.tsv")
    got = (tmp_path / "port" / "phonemes.tsv").read_bytes()
    assert got == (tmp_path / "jax" / "phonemes.tsv").read_bytes()
    assert got.count(b"\n") == 42 and got.startswith(b"AA\t0\nAE\t1\n")


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_load_config_matches_jax(path):
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()
