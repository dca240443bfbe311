"""PyTorch port, binary morphology (``ops/morphology.py``) against the JAX
package's on the same numpy-seeded masks, on the CPU.

Erode, dilate and their chain sum small integers exactly in float32, so
they must agree exactly (``torch.equal``), for even kernels too (cv2's
anchor puts the larger pad before). The box filter is a float mean:
within 1e-6. The port takes the majority vote on the integer window sum;
the JAX package on a float32 mean of products by 1/25, which can round an
exact tie (window sum == 12.5 * n, reachable for even n) either way: the
two must agree everywhere else, and every disagreement must be such a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.ops import morphology as JM
from ab_line_classifier_torch.ops import morphology as TM

KERNEL_SIZES = (3, 5, 24, 25)
FRAME_SIZES = ((37, 53), (61, 45))


def _masks(n, hw, seed, p=0.5):
    return (np.random.default_rng(seed).random((n,) + hw) < p).astype(
        np.float32)


def _blobby(n, hw, seed):
    """Masks with large connected regions (smoothed noise thresholded), so
    erode and dilate keep something at the larger kernels."""
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + hw).astype(np.float32)
    t = torch.nn.functional.avg_pool2d(torch.from_numpy(x)[:, None], 9,
                                       stride=1, padding=4)[:, 0].numpy()
    return (t > 0.5).astype(np.float32)


def test_ellipse_kernel_equal_for_sizes_1_to_60():
    for size in range(1, 61):
        np.testing.assert_array_equal(TM.ellipse_kernel(size),
                                      JM.ellipse_kernel(size),
                                      err_msg=f"size {size}")


def test_ellipse_kernel_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    for size in (1, 2, 3, 4, 6, 24, 25, 54):
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        np.testing.assert_array_equal(TM.ellipse_kernel(size),
                                      k.astype(np.float32))


@pytest.mark.parametrize("hw", FRAME_SIZES)
@pytest.mark.parametrize("size", KERNEL_SIZES)
def test_erode_and_dilate_equal_to_jax(size, hw):
    for masks in (_masks(3, hw, size), _blobby(3, hw, size)):
        k = TM.ellipse_kernel(size)
        want_d = np.array(JM.binary_dilate(jnp.asarray(masks),
                                             jnp.asarray(k)))
        want_e = np.array(JM.binary_erode(jnp.asarray(masks),
                                            jnp.asarray(k)))
        got_d = TM.binary_dilate(torch.from_numpy(masks), torch.from_numpy(k))
        got_e = TM.binary_erode(torch.from_numpy(masks), torch.from_numpy(k))
        assert torch.equal(got_d, torch.from_numpy(want_d))
        assert torch.equal(got_e, torch.from_numpy(want_e))


def test_even_kernel_anchor_matches_cv2():
    """An even element shifted by ``padding="same"``'s convention would
    differ from cv2 by one pixel."""
    cv2 = pytest.importorskip("cv2")
    masks = _masks(2, (41, 47), 7)
    for size in (4, 24):
        k = TM.ellipse_kernel(size)
        got_d = TM.binary_dilate(torch.from_numpy(masks),
                                 torch.from_numpy(k)).numpy()
        got_e = TM.binary_erode(torch.from_numpy(masks),
                                torch.from_numpy(k)).numpy()
        ku8 = k.astype(np.uint8)
        for i, m in enumerate(masks.astype(np.uint8)):
            np.testing.assert_array_equal(got_d[i], cv2.dilate(m, ku8))
            np.testing.assert_array_equal(got_e[i], cv2.erode(m, ku8))


@pytest.mark.parametrize("hw", FRAME_SIZES)
@pytest.mark.parametrize("erode,dilate", [(3, 5), (5, 3), (24, 25),
                                          (25, 24)])
def test_clean_binary_masks_equal_to_jax(erode, dilate, hw):
    masks = _blobby(4, hw, erode * dilate)
    want = np.array(JM.clean_binary_masks(jnp.asarray(masks),
                                            erode_size=erode,
                                            dilate_size=dilate))
    got = TM.clean_binary_masks(torch.from_numpy(masks), erode_size=erode,
                                dilate_size=dilate)
    assert torch.equal(got, torch.from_numpy(want))


def test_clean_masks_thresholds_like_jax():
    probs = np.random.default_rng(3).random((3, 37, 53)).astype(np.float32)
    want = np.array(JM.clean_masks(jnp.asarray(probs), erode_size=3,
                                     dilate_size=5))
    got = TM.clean_masks(torch.from_numpy(probs), erode_size=3,
                         dilate_size=5)
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("hw", FRAME_SIZES)
def test_box_filter_within_1e_6(hw):
    x = np.random.default_rng(5).integers(0, 12, (2,) + hw).astype(
        np.float32)
    want = np.asarray(JM.box_filter(jnp.asarray(x)))
    got = TM.box_filter(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4, 5, 10, 11])
def test_majority_vote_equal_except_exact_ties(n):
    masks = _masks(n, (45, 61), 100 + n)
    want = np.asarray(JM.majority_average_mask(jnp.asarray(masks)))
    got = TM.majority_average_mask(torch.from_numpy(masks)).numpy()
    window = TM._window_sum(torch.from_numpy(masks.sum(0))[None], 5)[0]
    ties = (2 * window.numpy() == 25 * n)
    differ = got != want
    assert not (differ & ~ties).any()
    if n % 2:
        assert not ties.any() and not differ.any()
    # A tie is a 1 in the port (the JAX package's documented choice).
    assert (got[ties] == 1).all()
    print(f"n={n}: {int(ties.sum())} ties, {int(differ.sum())} rounded to 0 "
          f"by the float mean")


def test_bounding_box_equal():
    for seed in range(4):
        m = np.zeros((30, 40), np.float32)
        r0, c0 = np.random.default_rng(seed).integers(0, 20, 2)
        m[r0:r0 + 7, c0:c0 + 11] = 1
        assert TM.bounding_box(m) == JM.bounding_box(m)
        assert TM.bounding_box(torch.from_numpy(m)) == JM.bounding_box(m)
    empty = np.zeros((30, 40), np.float32)
    assert TM.bounding_box(empty) == JM.bounding_box(empty) == (0, 29, 0, 39)
