"""Nothing a run loads is JAX or the JAX package, by whole top-level name,
and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from portbench.harness import HERE, ROOT, forbidden_modules


def test_whole_name_check():
    found = forbidden_modules(["m2tts_tpu_torch", "m2tts_tpu_torch.serving",
                               "jaxlib.xla", "m2tts_tpu.models", "jax",
                               "flax", "jaxtyping", "numpy"])
    assert found == ["flax", "jax", "jaxlib.xla", "m2tts_tpu.models"]


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.readings, "
            "portbench.sweep; import portbench.drivers.bulk, "
            "portbench.drivers.stream, portbench.drivers.gan_train, "
            "portbench.train_faults, portbench.train_readings, "
            "portbench.train_look; "
            "from portbench.cellkit import Cell; "
            "import m2tts_tpu_torch.serving.pipeline, "
            "m2tts_tpu_torch.serving.stream_batcher, "
            "m2tts_tpu_torch.training.trainer_stage2; "
            "from portbench.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("m2tts_tpu_torch", "m2tts_tpu",
                                               "jax"), (path, n)
    code = ("import sys; import portbench.reference.model, "
            "portbench.reference.text, portbench.reference.quant, "
            "portbench.reference.gan, "
            "portbench.weights; print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('m2tts')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "flagship.bulk", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
