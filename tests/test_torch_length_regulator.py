"""Length regulator of the PyTorch port against the JAX one: identical
durations give identical integers (idx, mask, total) and the same
expanded hiddens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m2tts_tpu.ops import length_regulator as jlr
from m2tts_tpu_torch.ops import length_regulator as tlr

torch.set_num_threads(2)

CASES = {
    "integer": np.array([[2, 3, 1, 0], [1, 1, 1, 1]], np.float32),
    "zeros": np.array([[0, 0, 0, 0], [0, 2, 0, 3]], np.float32),
    "fractional": np.array([[0.4, 1.99, 2.5, 0.999], [3.01, 0.0, 1.5, 7.7]],
                           np.float32),
    "over_max_frames": np.array([[9, 9, 9, 9], [30, 0, 1, 2]], np.float32),
    "negative": np.array([[-1.5, 2, -0.2, 3], [1, -4, 2, 0]], np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_frames", [1, 6, 16])
def test_indices_mask_total_exact(case, max_frames):
    d = CASES[case]
    ref = [np.asarray(a) for a in
           jlr.duration_to_frame_indices(jnp.asarray(d), max_frames)]
    out = [t.numpy() for t in
           tlr.duration_to_frame_indices(torch.from_numpy(d), max_frames)]
    for r, o, name in zip(ref, out, ("idx", "mask", "total")):
        assert r.shape == o.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)


def test_regulate_lengths_matches(rng):
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    d = rng.uniform(0, 4, size=(3, 5)).astype(np.float32)
    d[2] = 0.0  # an utterance with no frames at all
    ref = jlr.regulate_lengths(jnp.asarray(x), jnp.asarray(d), 12)
    out = tlr.regulate_lengths(torch.from_numpy(x), torch.from_numpy(d), 12)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
