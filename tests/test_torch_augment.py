"""PyTorch port, augmentation: the port's warp against the JAX package's
on identical parts (rotation angle, zoom, translation, flip, brightness
delta), since the two random streams cannot match; and the distribution of
the parts the port draws.

* ``_affine_resample_matmul`` (the two-pass resample), ``_bilinear_sample``
  (4 taps) and ``_warp_quarter_decomposed`` (quarter turns peeled off,
  then the two passes) each against the JAX function of its name;
* the dispatch rule and the brightness shift, through each package's
  ``augment_batch`` with the parts fixed (JAX's ``_sample_parts`` patched,
  its brightness delta drawn from the same key the function splits):
  large rotations of square frames, small rotations, non-square frames,
  zoom ranges over 0.5 and frames over 160 px each take the sampler the
  JAX package takes; the sampler not taken lands far from JAX's output,
  so a wrong choice fails.

Tolerance: 1e-3 absolute on [0, 255] images, in float32 on smooth frames
that fade to 0 at their borders. In float64 (the JAX package under
``jax.enable_x64``) the port computes the same values to ~1e-12 on frames with
hard edges too; in float32 each package's own error on such frames reaches
~2e-3 (sample positions rounded near a jump), so the hard-edged frames are
held in float64 only.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.data import augment as jax_A
from ab_line_classifier_torch.data import augment as A

ATOL = 1e-3
CONFIG = dict(zoom=0.1, shift_w=0.2, shift_h=0.2, rotation=45.0,
              brightness=0.3, horizontal_flip=True)


def images(b, h, w, seed=0, sharp=False):
    """Frames in [0, 255]: smooth waves that fade to 0 at the borders, or
    (``sharp``) waves at full strength with a white block: hard edges."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    fade = (np.sin(np.pi * (yy + 0.5) / h) * np.sin(np.pi * (xx + 0.5) / w))
    out = np.zeros((b, h, w, 3), np.float32)
    for i in range(b):
        for c in range(3):
            fx, fy, ph = rng.uniform(0.05, 0.4, 2).tolist() + [rng.rand()]
            out[i, ..., c] = 127.5 + 120 * np.sin(fx * xx + fy * yy + 6 * ph)
        if sharp:
            out[i, h // 4:h // 2, w // 3:w // 2] = 255.0
        else:
            out[i] *= fade[..., None]
    return out


def held(jax_fn, port_fn, x, *args, dtype=np.float32):
    """``jax_fn`` and ``port_fn`` on the same numpy inputs in ``dtype``
    (float64: JAX under ``jax.enable_x64``), the port within ATOL."""
    arrays = [np.asarray(a, dtype) for a in (x,) + args]
    if dtype == np.float64:
        with jax.enable_x64(True):
            want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    else:
        want = np.asarray(jax_fn(*map(jnp.asarray, arrays)))
    got = port_fn(*(torch.tensor(a) for a in arrays)).numpy()
    assert got.dtype == want.dtype == dtype
    assert np.abs(want).max() > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def parts(b, hw, rotation, zoom=0.1, seed=1):
    """Numpy parts: angles over the whole range (or ±rotation·2π), zooms,
    translations, flips."""
    rng = np.random.RandomState(seed)
    turn = min(rotation * 2 * math.pi, math.pi)
    theta = rng.uniform(-turn, turn, b).astype(np.float32)
    zooms = (1 + rng.uniform(-zoom, zoom, b)).astype(np.float32)
    tx = (rng.uniform(-0.2, 0.2, b) * hw[1]).astype(np.float32)
    ty = (rng.uniform(-0.2, 0.2, b) * hw[0]).astype(np.float32)
    flip = np.where(rng.rand(b) < 0.5, -1.0, 1.0).astype(np.float32)
    return theta, zooms, tx, ty, flip


def torch_parts(p, delta=None):
    t = [torch.tensor(a) for a in p]
    b = len(p[0])
    d = (torch.zeros((b, 1, 1, 1)) if delta is None
         else torch.tensor(np.asarray(delta, np.float32)))
    return A.Parts(*t, d)


DTYPES = pytest.mark.parametrize("dtype,sharp", [(np.float32, False),
                                                 (np.float64, True)],
                                  ids=["float32", "float64-hard-edges"])


def affines(p, hw):
    return np.asarray(jax_A._affine_from_parts(*map(jnp.asarray, p), hw))


@DTYPES
def test_two_pass_resample_matches_jax(dtype, sharp):
    p = parts(6, (32, 32), rotation=0.1)
    held(jax.vmap(jax_A._affine_resample_matmul), A._affine_resample_matmul,
         images(6, 32, 32, sharp=sharp), affines(p, (32, 32)), dtype=dtype)


@DTYPES
def test_bilinear_sample_matches_jax(dtype, sharp):
    p = parts(6, (24, 40), rotation=45.0, zoom=0.6)
    held(jax.vmap(jax_A._bilinear_sample), A._bilinear_sample,
         images(6, 24, 40, sharp=sharp), affines(p, (24, 40)), dtype=dtype)


@DTYPES
def test_quarter_decomposed_warp_matches_jax(dtype, sharp):
    p = parts(16, (32, 32), rotation=45.0)
    quarter = np.mod(-np.round(p[0] / (np.pi / 2)), 4)
    assert set(quarter.astype(int)) == {0, 1, 2, 3}
    held(jax_A._warp_quarter_decomposed, A._warp_quarter_decomposed,
         images(16, 32, 32, sharp=sharp), *p, dtype=dtype)


# (frame size, zoom range, rotation factor, the sampler JAX picks)
DISPATCH = [((32, 32), 0.1, 45.0, "quarter turns + two passes"),
            ((32, 32), 0.1, 0.1, "two passes"),
            ((32, 40), 0.1, 45.0, "4 taps (not square)"),
            ((32, 32), 0.6, 45.0, "4 taps (zoom range)"),
            ((168, 168), 0.1, 0.1, "4 taps (over 160 px)")]


@pytest.mark.parametrize("hw,zoom,rotation,picked", DISPATCH,
                         ids=[d[3] for d in DISPATCH])
def test_augment_batch_dispatch_matches_jax(monkeypatch, hw, zoom, rotation,
                                            picked):
    b = 4
    x = images(b, *hw)
    p = parts(b, hw, rotation, zoom)
    cfg = dict(CONFIG, zoom=zoom, rotation=rotation)
    monkeypatch.setattr(jax_A, "_sample_parts",
                        lambda *a, **k: tuple(map(jnp.asarray, p)))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_A.augment_batch.__wrapped__(jnp.asarray(x), key,
                                                      **cfg))
    _, k_bright = jax.random.split(key)
    delta = np.asarray(jax.random.uniform(k_bright, (b, 1, 1, 1),
                                          minval=-0.3, maxval=0.3))
    got = A.apply_parts(torch.from_numpy(x), torch_parts(p, delta),
                        zoom=zoom, rotation=rotation,
                        brightness=cfg["brightness"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.min() >= 0.0 and got.max() <= 255.0
    # The choice matters: the sampler not taken lands over 100 x ATOL from
    # JAX's (1.4-30 gray levels on these frames).
    xt, pt = torch.from_numpy(x), torch_parts(p)
    other = (A._affine_resample_matmul if picked.startswith("4 taps")
             else A._bilinear_sample)(xt, A._affine_from_parts(*pt[:5], hw))
    assert np.abs(other.numpy() - np.clip(want - delta, 0, 255)).max() > 100 * ATOL


def test_sampled_parts_cover_their_ranges():
    """The config's parts at batch 8192: every quarter turn about equally
    often (the rotation factor 45 is an effectively uniform angle), zooms,
    shifts and deltas inside and across their ranges, flips half and half;
    one seed draws the same parts, another seed others."""
    n, hw = 8192, (128, 128)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return A.sample_parts(g, n, hw, torch.device("cpu"), **CONFIG)

    p = draw(0)
    quarter = torch.remainder(-torch.round(p.theta / (math.pi / 2)), 4)
    freq = torch.bincount(quarter.long(), minlength=4).float() / n
    assert ((freq > 0.22) & (freq < 0.28)).all(), freq
    assert p.theta.abs().max() <= 45 * 2 * math.pi
    for t, lo, hi in ((p.zooms, 0.9, 1.1), (p.tx, -25.6, 25.6),
                      (p.ty, -25.6, 25.6), (p.delta, -0.3, 0.3)):
        assert lo <= float(t.min()) < lo + 0.02 * (hi - lo)
        assert hi - 0.02 * (hi - lo) < float(t.max()) <= hi
    assert set(p.flip.tolist()) == {-1.0, 1.0}
    assert abs(float((p.flip < 0).float().mean()) - 0.5) < 0.03
    again, other = draw(0), draw(1)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    assert not torch.equal(p.theta, other.theta)


def test_augment_batch_keeps_shape_and_range():
    g = torch.Generator().manual_seed(3)
    x = torch.from_numpy(images(8, 32, 32))
    out = A.augment_batch(x, g, **CONFIG)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    assert not torch.equal(out, x)
