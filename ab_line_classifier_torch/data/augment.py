"""Data augmentation on the device (port of the JAX package's
``data/augment.py``).

Zoom, rotation, translation and horizontal flip compose into one inverse
affine map per image (output pixel -> input pixel, about the image
centre), resampled bilinearly with zero fill, then an absolute brightness
shift clipped to [0, 255]. The config knobs keep tf.keras 2.9's semantics,
as the JAX package does:

* ``ZOOM_RANGE`` -- the output->input scale is uniform in ``[1 - z, 1 +
  z]`` (``> 1`` zooms out);
* ``WIDTH/HEIGHT_SHIFT_RANGE`` -- shift fractions of the image size;
* ``ROTATION_RANGE`` -- a fraction **of 2π**: the config's 45 means ±45
  full turns, an effectively uniform angle;
* ``BRIGHTNESS_RANGE`` -- an absolute delta in gray levels, then a clip.

The warp computes what the JAX package computes, with the same dispatch
(:func:`_warp`): square frames up to 160 px with zoom ranges up to 0.5 and
a large rotation peel the nearest quarter turn off each angle as a
``rot90`` of the source (:func:`_warp_quarter_decomposed`) and resample the
residual (within ±45°) in two passes, along x and then along y
(:func:`_affine_resample_matmul`, Catmull–Smith); small rotations take the
two passes directly; anything else the 4-tap bilinear sampler
(:func:`_bilinear_sample`). The two resamplers differ by up to ~25-30 gray
levels at fill edges, so the choice matters. The JAX package contracts
each pass with ``[H, W, W]`` tent-weight matrices on the MXU; each pass is
a 2-tap linear interpolation along one axis, which is what the port
computes, with gathers.

Randomness: the parts of a batch are drawn from the ``torch.Generator``
the caller passes (on the images' device), one draw per part per batch.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch


def affine_params_from_config(aug_cfg: Dict) -> Dict[str, float]:
    return dict(
        zoom=float(aug_cfg.get("ZOOM_RANGE", 0.0)),
        shift_w=float(aug_cfg.get("WIDTH_SHIFT_RANGE", 0.0)),
        shift_h=float(aug_cfg.get("HEIGHT_SHIFT_RANGE", 0.0)),
        rotation=float(aug_cfg.get("ROTATION_RANGE", 0.0)),
        brightness=float(aug_cfg.get("BRIGHTNESS_RANGE", 0.0)),
        horizontal_flip=bool(aug_cfg.get("HORIZONTAL_FLIP", False)),
    )


class Parts(NamedTuple):
    """The per-image parts of one batch's augmentation, float32 ``[B]``
    each (``delta`` ``[B, 1, 1, 1]``): rotation angle, output->input zoom,
    translation in pixels, flip (-1 or 1) and brightness delta."""

    theta: torch.Tensor
    zooms: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    flip: torch.Tensor
    delta: torch.Tensor


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def sample_parts(generator: torch.Generator, batch: int,
                 hw: Tuple[int, int], device: torch.device, *,
                 zoom: float = 0.0, shift_w: float = 0.0,
                 shift_h: float = 0.0, rotation: float = 0.0,
                 brightness: float = 0.0,
                 horizontal_flip: bool = False) -> Parts:
    """Draw one batch's parts: Keras RandomZoom / RandomRotation (±rotation
    · 2π) / RandomTranslation / RandomFlip / brightness, each uniform."""
    h, w = hw
    turn = rotation * 2.0 * math.pi
    zooms = 1.0 + _uniform(generator, (batch,), -zoom, zoom, device)
    theta = _uniform(generator, (batch,), -turn, turn, device)
    tx = _uniform(generator, (batch,), -shift_w, shift_w, device) * w
    ty = _uniform(generator, (batch,), -shift_h, shift_h, device) * h
    if horizontal_flip:
        flip = torch.where(torch.rand((batch,), generator=generator,
                                      device=device) < 0.5, -1.0, 1.0)
    else:
        flip = torch.ones((batch,), device=device)
    delta = _uniform(generator, (batch, 1, 1, 1), -brightness, brightness,
                     device)
    return Parts(theta, zooms, tx, ty, flip, delta)


def _affine_from_parts(theta, zooms, tx, ty, flip, hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Inverse affine maps ``[B, 2, 3]`` about the image centre: ``p_in = A
    @ (p_out - c - t) + c``, the output->input scale ``zooms`` itself."""
    h, w = hw
    cos, sin = torch.cos(theta), torch.sin(theta)
    a11 = cos * zooms * flip
    a12 = sin * zooms
    a21 = -sin * zooms * flip
    a22 = cos * zooms
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    b1 = cx - a11 * (cx + tx) - a12 * (cy + ty)
    b2 = cy - a21 * (cx + tx) - a22 * (cy + ty)
    return torch.stack([torch.stack([a11, a12, b1], -1),
                        torch.stack([a21, a22, b2], -1)], dim=1)


def _taps(src: torch.Tensor, coord: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation of ``src`` ``[B, H, W, C]`` along ``axis`` (1:
    rows, 2: columns) at float positions ``coord`` ``[B, H, W]``, each
    output element from the two source elements beside its position; a tap
    outside the image contributes 0 (the tent weight ``max(0, 1 - |coord -
    i|)`` of the JAX package's matrices, which is nonzero at those two
    only)."""
    n = src.shape[axis]
    c = src.shape[-1]
    i0 = torch.floor(coord)
    frac = coord - i0
    i0 = i0.to(torch.int64)
    out = None
    for i, wgt in ((i0, 1.0 - frac), (i0 + 1, frac)):
        valid = (i >= 0) & (i < n)
        idx = i.clamp(0, n - 1).unsqueeze(-1).expand(-1, -1, -1, c)
        term = torch.gather(src, axis, idx) * (wgt * valid).unsqueeze(-1)
        out = term if out is None else out + term
    return out


def _bilinear_sample(images: torch.Tensor,
                     affines: torch.Tensor) -> torch.Tensor:
    """Sample ``[B, H, W, C]`` images through inverse affines ``[B, 2, 3]``
    with the 4-tap bilinear gather, fill 0."""
    b, h, w, c = images.shape
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    a = affines[:, :, :, None, None]
    x_in = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]
    y_in = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    x0, y0 = torch.floor(x_in), torch.floor(y_in)
    wx, wy = (x_in - x0)[..., None], (y_in - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    flat = images.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals.reshape(b, h, w, c) * valid[..., None]

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _affine_resample_matmul(images: torch.Tensor,
                            affines: torch.Tensor) -> torch.Tensor:
    """The inverse-affine bilinear resample in two passes (Catmull–Smith):
    along x, each row's sample positions affine in (x, y), then along y per
    column. Needs ``a22 != 0`` (a residual rotation within ±45° and zooms
    within ~2x keep it away from 0). The JAX function of this name
    contracts tent-weight matrices; here each pass is :func:`_taps`."""
    b, h, w, _ = images.shape
    dev = images.device
    a = affines[:, :, :, None, None]
    a11, a12, b1 = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
    a21, a22, b2 = a[:, 1, 0], a[:, 1, 1], a[:, 1, 2]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    # Pass A along x: tmp[y, x] = in(u(x, y), y) with u(x, v) = (a11 - a12
    # a21 / a22) x + (a12 / a22) v + (b1 - a12 b2 / a22).
    alpha = a11 - a12 * a21 / a22
    beta = a12 / a22
    gamma = b1 - a12 * b2 / a22
    tmp = _taps(images, alpha * xs + beta * ys + gamma, axis=2)
    # Pass B along y: out[y, x] = tmp(y_in(y, x), x).
    return _taps(tmp, a21 * xs + a22 * ys + b2, axis=1)


def _prerotate_batch(images: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``rot90`` of each square image of ``[B, H, W, C]`` by its own ``j``
    quarter turns (``np.rot90`` / ``torch.rot90`` over axes 1, 2)."""
    jb = j.view(-1, 1, 1, 1)
    out = images
    for k in (1, 2, 3):
        out = torch.where(jb == k, torch.rot90(images, k, dims=(1, 2)), out)
    return out


def _warp_quarter_decomposed(images, theta, zooms, tx, ty, flip):
    """Warp square images by arbitrary-angle affines: the nearest quarter
    turn of each angle is peeled off as a ``rot90`` of the source, and the
    residual (within ±45°) runs through the two-pass resampler."""
    _, h, w, _ = images.shape
    k_quarter = torch.round(theta / (math.pi / 2.0))
    j = torch.remainder(-k_quarter, 4.0).to(torch.int64)
    affines = _affine_from_parts(theta, zooms, tx, ty, flip, (h, w))
    # Fold the quarter turn out of the affine: left-multiply by the
    # rotation [[cos, sin], [-sin, cos]] at j quarter turns (entries 0 and
    # +-1, picked on the device).
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    cos = torch.where(j == 0, one, torch.where(j == 2, -one, zero))
    sin = torch.where(j == 1, one, torch.where(j == 3, -one, zero))
    q = torch.stack([torch.stack([cos, sin], -1),
                     torch.stack([-sin, cos], -1)], dim=1)
    lin = torch.bmm(q, affines[:, :, :2])
    # b' = c - A' (c + t), as _affine_from_parts builds b.
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    px, py = cx + tx, cy + ty
    boff = torch.stack([cx - (lin[:, 0, 0] * px + lin[:, 0, 1] * py),
                        cy - (lin[:, 1, 0] * px + lin[:, 1, 1] * py)], -1)
    affines2 = torch.cat([lin, boff[:, :, None]], dim=2)
    return _affine_resample_matmul(_prerotate_batch(images, j), affines2)


def _warp(images: torch.Tensor, parts: Parts, zoom: float,
          rotation: float) -> torch.Tensor:
    """The JAX package's dispatch: the two-pass warp needs ``a22`` (cos of
    the residual rotation times the zoom) away from 0, so square frames
    with a large rotation peel quarter turns first, and frames over 160 px
    or zoom ranges over 0.5 take the 4-tap sampler; non-square frames with
    a large rotation too."""
    _, h, w, _ = images.shape
    small_rot = rotation * 2.0 * math.pi <= math.pi / 4 + 1e-6
    use_passes = max(h, w) <= 160 and zoom <= 0.5 and (small_rot or h == w)
    p = parts
    if use_passes and not small_rot:
        return _warp_quarter_decomposed(images, p.theta, p.zooms, p.tx,
                                        p.ty, p.flip)
    affines = _affine_from_parts(p.theta, p.zooms, p.tx, p.ty, p.flip,
                                 (h, w))
    sampler = _affine_resample_matmul if use_passes else _bilinear_sample
    return sampler(images, affines)


def apply_parts(images: torch.Tensor, parts: Parts, *, zoom: float = 0.0,
                rotation: float = 0.0, brightness: float = 0.0
                ) -> torch.Tensor:
    """Warp a float ``[B, H, W, C]`` batch in [0, 255] by ``parts``, then
    shift its brightness by ``parts.delta`` and clip (when ``brightness``
    is set)."""
    out = _warp(images.to(torch.float32), parts, zoom, rotation)
    if brightness:
        out = torch.clamp(out + parts.delta, 0.0, 255.0)
    return out


def augment_batch(images: torch.Tensor, generator: torch.Generator, *,
                  zoom: float = 0.0, shift_w: float = 0.0,
                  shift_h: float = 0.0, rotation: float = 0.0,
                  brightness: float = 0.0,
                  horizontal_flip: bool = False) -> torch.Tensor:
    """Augment a float ``[B, H, W, C]`` batch in [0, 255]: the fused affine
    (bilinear, zero fill), then the brightness shift with clipping."""
    b, h, w, _ = images.shape
    parts = sample_parts(generator, b, (h, w), images.device, zoom=zoom,
                         shift_w=shift_w, shift_h=shift_h, rotation=rotation,
                         brightness=brightness,
                         horizontal_flip=horizontal_flip)
    return apply_parts(images, parts, zoom=zoom, rotation=rotation,
                       brightness=brightness)
