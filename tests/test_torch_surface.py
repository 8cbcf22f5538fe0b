"""The port's public surface covers the JAX package's.

Both trees are read with ``ast`` only (neither package is imported). Every
public top-level function and class of every ``m2tts_tpu/**/*.py`` module,
every public method of its classes and a flax module's ``__call__`` must

- exist under the same name in the port's module of the same relative
  path, or
- have an entry in ``RENAMED`` whose port name exists, or
- have an entry in ``DEPARTURES`` with its reason.

The keyword parameters of the entry points in ``KEYWORDS`` are held the
same way (``KEYWORD_DEPARTURES``). An entry for a JAX name that does not
exist, or that the port has under the same name, fails too, and the
departures listed in ``ROADMAP.md`` are exactly the two departure tables'.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "m2tts_tpu", ROOT / "m2tts_tpu_torch"

_FORWARD = {f"{path}::{cls}.__call__": f"{path}::{cls}.forward"
            for path, classes in (
                ("models/components.py", (
                    "MultiHeadSelfAttention", "FeedForward",
                    "TransformerEncoderLayer", "Conv1d", "ConvTranspose1d",
                    "ConvBlock", "VariancePredictor", "LightweightResBlock")),
                ("models/discriminator.py", (
                    "ScaleDiscriminator", "MultiScaleDiscriminator")),
                ("models/tts_model.py", (
                    "TextEncoder", "DurationPredictor", "MelDecoder",
                    "Vocoder", "M2TTS")))
            for cls in classes}

#: JAX name → the port's name for the same thing
RENAMED = {
    **_FORWARD,  # a flax module's __call__ is an nn.Module's forward
    "models/tts_model.py::M2TTS.setup": "models/tts_model.py::M2TTS.__init__",
    # the spectral-normed conv is Conv1d(spectral_norm=True)
    "models/components.py::SNConv": "models/components.py::Conv1d",
    "models/components.py::SNConv.__call__":
        "models/components.py::Conv1d.forward",
    "ops/grouped_conv.py::conv1d_s1_wgrad": "ops/grouped_conv.py::conv1d_s1",
    # one Hopper kernel wrapper serves both TPU layouts
    "ops/pallas/vocoder.py::fused_vocoder_forward":
        "ops/cuda/vocoder.py::fused_vocoder_forward",
    "ops/pallas/vocoder_packed.py::fused_vocoder_packed_forward":
        "ops/cuda/vocoder.py::fused_vocoder_forward",
    "ops/pallas/vocoder.py::build_fused_vocoder":
        "serving/pipeline.py::make_vocoder_fn",
    "ops/pallas/vocoder_packed.py::build_fused_vocoder_packed":
        "serving/pipeline.py::make_vocoder_fn",
    "serving/pipeline.py::make_kernel_vocoder_fn":
        "serving/pipeline.py::make_vocoder_fn",
    "training/trainer.py::make_optimizer": "training/trainer.py::Optimizer",
}

#: JAX names the port leaves out on purpose (each listed in ROADMAP.md)
DEPARTURES = {
    "ops/pallas/vocoder_packed.py::pick_tile":
        "Mosaic's alignment escape (None = fall back); the Hopper kernels "
        "take every shape, tiled by ops/cuda/vocoder.py::tc_plan",
    "parallel/mesh.py::replicated":
        "a jax NamedSharding; the port places whole tensors with DTensor's "
        "Replicate() (parallel/partition.py)",
    "utils/device.py::honor_platform_env":
        "JAX_PLATFORMS against the TPU plugin; the port's entry points take "
        "device= / --device",
    "utils/device.py::enable_persistent_compile_cache":
        "XLA's compile cache; the port builds its kernels once a source "
        "hash into build/kernels and captures graphs in-process",
    "utils/device.py::no_persistent_cache":
        "the same XLA compile cache",
}

#: (module, class or Class.method) whose keyword parameters are held
KEYWORDS = (
    ("serving/pipeline.py", "Synthesizer"),
    ("serving/streaming.py", "StreamingSynthesizer"),
    ("serving/streaming.py", "StreamingVocoder"),
    ("serving/streaming.py", "StreamingVocoder.stream_device"),
    ("training/trainer.py", "Stage1Trainer"),
    ("training/trainer_stage2.py", "Stage2Trainer"),
    ("utils/checkpoint.py", "CheckpointManager"),
)

KEYWORD_DEPARTURES = {
    "serving/pipeline.py::Synthesizer(params=)":
        "the weights live in the nn.Module",
    "serving/streaming.py::StreamingSynthesizer(params=)":
        "the weights live in the nn.Module",
    "serving/streaming.py::StreamingVocoder(params=)":
        "the weights live in the nn.Module",
    "serving/streaming.py::StreamingVocoder.stream_device(total=)":
        "the host places the windows from total_frames; no device total",
    "utils/checkpoint.py::CheckpointManager(best_fn=)":
        "orbax's metric-ranked retention; the trainers pin the best step "
        "under <dir>/best, and no JAX caller passes best_fn",
}


def _module(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _public(path: Path) -> list:
    """A JAX module's public names: top-level functions and classes, and
    each class's public methods and ``__call__``."""
    out = []
    for node in _module(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and (not m.name.startswith("_") or m.name == "__call__")]
    return out


def _defined(path: Path) -> set:
    """Every name a port module defines at the top level or in a class
    body (functions, classes, methods, assignments)."""
    if not path.exists():
        return set()
    out = set()

    def targets(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return [node.name]
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            return [node.target.id]
        return []

    for node in _module(path).body:
        out.update(targets(node))
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{n}" for m in node.body
                       for n in targets(m))
    return out


def _port_has(qualified: str) -> bool:
    rel, name = qualified.split("::")
    return name in _defined(PORT / rel)


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_port_name(rel):
    have = _defined(PORT / rel)
    missing = []
    for name in _public(JAX / rel):
        key = f"{rel}::{name}"
        if key in RENAMED:
            assert _port_has(RENAMED[key]), \
                f"{key} → {RENAMED[key]}: no such port name"
        elif key not in DEPARTURES and name not in have:
            missing.append(key)
    assert not missing, f"JAX names with no port name or entry: {missing}"


def test_entries_name_real_jax_names():
    for key in list(RENAMED) + list(DEPARTURES):
        rel, name = key.split("::")
        assert name in _public(JAX / rel), f"stale entry {key}"
        # an entry is for a name the port lacks under the same name
        assert not _port_has(key), f"unneeded entry {key}"
    assert all(DEPARTURES.values()) and all(KEYWORD_DEPARTURES.values())


def _keywords(path: Path, qualname: str):
    """The parameters (after ``self``) of a class's ``__init__`` or of a
    ``Class.method``; None when there is none."""
    cls, _, method = qualname.partition(".")
    method = method or "__init__"
    for node in _module(path).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and m.name == method:
                    a = m.args
                    return [x.arg for x in a.posonlyargs + a.args
                            + a.kwonlyargs][1:]
    return None


@pytest.mark.parametrize("rel,qualname", KEYWORDS,
                         ids=[q for _, q in KEYWORDS])
def test_entry_point_keywords(rel, qualname):
    want = _keywords(JAX / rel, qualname)
    have = _keywords(PORT / rel, qualname)
    assert want is not None and have is not None, (rel, qualname)
    missing = [kw for kw in want if kw not in have
               and f"{rel}::{qualname}({kw}=)" not in KEYWORD_DEPARTURES]
    assert not missing, f"{rel}::{qualname} lacks {missing}"


def test_keyword_departures_are_real():
    for key in KEYWORD_DEPARTURES:
        rel, call = key.split("::")
        qualname, kw = re.fullmatch(r"([\w.]+)\((\w+)=\)", call).groups()
        assert (rel, qualname) in KEYWORDS, key
        assert kw in _keywords(JAX / rel, qualname), f"stale entry {key}"
        assert kw not in _keywords(PORT / rel, qualname), \
            f"unneeded entry {key}"


def _roadmap_departures() -> set:
    """The ``path::name`` entries (paths of the JAX package) of
    ROADMAP.md's list of deliberate departures."""
    lines = (ROOT / "ROADMAP.md").read_text().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("These departures are deliberate"))
    block = []
    for line in lines[start + 1:]:
        if not (line.startswith("- ") or line.startswith("  ")):
            break
        block.append(line)
    keys = re.findall(r"`([\w/]+\.py::[\w.]+(?:\(\w+=\))?)`",
                      "\n".join(block))
    return {k for k in keys if (JAX / k.split("::")[0]).exists()}


def test_roadmap_lists_the_same_departures():
    assert _roadmap_departures() == set(DEPARTURES) | set(KEYWORD_DEPARTURES)
