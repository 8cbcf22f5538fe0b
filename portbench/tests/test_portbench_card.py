"""On the card: each cell's run, shortened, comes out correct. Skips
without a CUDA device (decided in the fixture, not at import)."""

import pytest

from portbench.harness import manifest

MAN = manifest()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("name", [c["name"] for c in MAN["workloads"]])
def test_cell_runs_correct(card, name):
    from portbench.harness import find_cell
    from portbench.run import Context, run_cell

    ctx = Context(find_cell(MAN, name), 2 ** 34 + 3, 3.0, False, device=card)
    result = run_cell(MAN, ctx)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
