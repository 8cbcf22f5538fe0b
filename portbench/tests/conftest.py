"""Fixtures of the harness's tests: the repository root on the path, and
a tiny configuration that runs the drivers on the CPU in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_config():
    from portbench.harness import load_json

    cfg = load_json("configs", "flagship")
    m = cfg["model"]
    m["text_encoder"].update(hidden_dim=16, num_layers=1, num_heads=2)
    m["duration_predictor"]["hidden_dim"] = 16
    m["decoder"].update(hidden_dim=16, num_layers=1)
    m["vocoder"].update(hidden_channels=32)
    return cfg


@pytest.fixture
def tiny():
    import torch

    torch.set_num_threads(2)
    return tiny_config()
