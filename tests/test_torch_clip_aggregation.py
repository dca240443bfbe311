"""PyTorch port, clip aggregation: fuzzed against the JAX package.

``contiguous`` (integer run lengths, hard 0/1 output) and the masks must
match exactly; the float means of ``average`` and ``sliding_window`` within
1e-6 (float32 sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.ops import clip_aggregation as jax_agg
from ab_line_classifier_torch.ops import clip_aggregation as torch_agg
from ab_line_classifier_torch.predict.predict import group_clip_probs

ALGORITHMS = ("average", "contiguous", "sliding_window")


def fuzz_case(seed):
    """Padded [n_clips, T, 2] probs with ragged valid lengths (some shorter
    than the window, one empty) and runs of confident frames."""
    rng = np.random.RandomState(seed)
    n_clips, t = 17, int(rng.randint(5, 40))
    p1 = rng.rand(n_clips, t).astype(np.float32)
    p1[rng.rand(n_clips, t) < 0.3] = 0.95  # runs above the threshold
    probs = np.stack([1.0 - p1, p1], axis=-1)
    lengths = rng.randint(0, t + 1, n_clips)
    lengths[0], lengths[1] = t, 0
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return probs, mask


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_aggregate_matches_jax(algorithm, seed):
    probs, mask = fuzz_case(seed)
    kw = dict(algorithm=algorithm, classification_threshold=0.7,
              contiguity_threshold=3, window=4)
    want = np.asarray(jax_agg.aggregate_clips(jnp.asarray(probs),
                                              jnp.asarray(mask), **kw))
    got = torch_agg.aggregate_clips(torch.from_numpy(probs),
                                    torch.from_numpy(mask), **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if algorithm == "contiguous":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_max_contiguous_positive_exact(seed):
    rng = np.random.RandomState(seed)
    preds = rng.rand(9, 50) < 0.6
    mask = rng.rand(9, 50) < 0.9
    want = np.asarray(jax_agg.max_contiguous_positive(jnp.asarray(preds),
                                                      jnp.asarray(mask)))
    got = torch_agg.max_contiguous_positive(torch.from_numpy(preds),
                                            torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_longer_than_clips_is_zero():
    probs, mask = fuzz_case(0)
    out = torch_agg.sliding_window_clip_probs(
        torch.from_numpy(probs), window=probs.shape[1] + 1,
        mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(out[:, 1].numpy(), 0.0)


def test_group_clip_probs_substring_match():
    paths = ["clip01_0.jpg", "clip02_0.jpg", "clip01_1.jpg", "x/clip03_5.png"]
    probs = np.arange(8, dtype=np.float32).reshape(4, 2)
    padded, mask = group_clip_probs(paths, probs,
                                    ["clip01", "clip02", "clip03"])
    np.testing.assert_array_equal(mask, [[1, 1], [1, 0], [1, 0]])
    np.testing.assert_array_equal(padded[0], probs[[0, 2]])
    np.testing.assert_array_equal(padded[2, 0], probs[3])
    with pytest.raises(ValueError, match="match no rows"):
        group_clip_probs(paths, probs, ["clip09"])
