"""Stage-1 losses of the PyTorch port (``training/losses.py``) against the
JAX package's on seeded inputs, a zero-length row included (f32, rtol 1e-6),
and ``EarlyStopping``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.training import losses as jlosses
from m2tts_tpu_torch.training import losses as tlosses

torch.set_num_threads(2)


@pytest.mark.parametrize("with_lengths", [True, False])
def test_stage1_losses_match_jax(with_lengths):
    rng = np.random.default_rng(0)
    B, T, C, S = 4, 37, 8, 11
    mel_p = rng.standard_normal((B, T, C)).astype(np.float32)
    mel_t = rng.standard_normal((B, T, C)).astype(np.float32)
    dur_p = rng.uniform(0, 5, (B, S)).astype(np.float32)
    dur_t = rng.uniform(0, 5, (B, S)).astype(np.float32)
    lengths = np.array([37, 12, 0, 1], np.int32)  # row 2 has no frames
    lj = jnp.asarray(lengths) if with_lengths else None
    lt = torch.from_numpy(lengths) if with_lengths else None
    ref = jlosses.stage1_losses(jnp.asarray(mel_p), jnp.asarray(mel_t),
                                jnp.asarray(dur_p), jnp.asarray(dur_t), lj,
                                0.7, 0.2)
    got = tlosses.stage1_losses(torch.from_numpy(mel_p),
                                torch.from_numpy(mel_t),
                                torch.from_numpy(dur_p),
                                torch.from_numpy(dur_t), lt, 0.7, 0.2)
    assert set(got) == set(ref) == {"mel_loss", "duration_loss", "total_loss"}
    for k in ref:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


def test_zero_length_row_divides_by_one():
    pred = torch.ones((2, 5, 3))
    target = torch.zeros((2, 5, 3))
    loss = tlosses.masked_mel_l1(pred, target, torch.tensor([5, 0]))
    assert loss.item() == pytest.approx(0.5)  # (1 + 0) / 2


def test_early_stopping_matches_jax():
    seq = [1.0, 0.9, 0.8995, 0.95, 0.7, 0.7, 0.71, 0.6999]
    t, j = tlosses.EarlyStopping(3, 0.001), jlosses.EarlyStopping(3, 0.001)
    assert [t(v) for v in seq] == [j(v) for v in seq]
    assert (t.best_loss, t.wait) == (j.best_loss, j.wait)
