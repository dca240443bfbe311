"""The training augmentation (tf.keras 2.9 semantics as the project states
them): per image an output->input zoom ``1 + U(-z, z)``, a rotation
``U(-r, r) * 2 pi``, a shift ``U(-s, s)`` of the width and height and a
horizontal flip with probability 1/2 compose into one inverse affine map
about the image centre, resampled with zero fill; then an absolute
brightness shift ``U(-b, b)``, clipped to [0, 255].

Draws: one uniform draw per part per batch from the step's augmentation
generator, in the order zoom, angle, x shift, y shift, flip, brightness.

Resampling, as the project defines it for square frames of up to 160
pixels: the nearest quarter turn of the angle is taken off as a ``rot90``
of the source, and the residual map is resampled in two linear passes
(along x with positions affine in x and y, then along y), each pass
interpolating between the two pixels beside a position and taking 0
outside the image."""

from __future__ import annotations

import math

import torch


def draw_parts(generator: torch.Generator, batch: int, hw, params: dict,
               device):
    h, w = hw

    def uniform(shape, half):
        u = torch.rand(shape, generator=generator, device=device)
        return -half + 2.0 * half * u

    zoom = 1.0 + uniform((batch,), params["zoom"])
    theta = uniform((batch,), params["rotation"] * 2.0 * math.pi)
    tx = uniform((batch,), params["shift_w"]) * w
    ty = uniform((batch,), params["shift_h"]) * h
    if params["horizontal_flip"]:
        u = torch.rand((batch,), generator=generator, device=device)
        flip = torch.where(u < 0.5, -1.0, 1.0)
    else:
        flip = torch.ones((batch,), device=device)
    delta = uniform((batch, 1, 1, 1), params["brightness"])
    return zoom, theta, tx, ty, flip, delta


def _interp(src: torch.Tensor, pos: torch.Tensor, axis: int) -> torch.Tensor:
    """``src`` ``[B, H, W, C]`` interpolated along ``axis`` (1 rows, 2
    columns) at positions ``pos`` ``[B, H, W]``; 0 outside."""
    n, c = src.shape[axis], src.shape[-1]
    lo = torch.floor(pos)
    t = pos - lo
    lo = lo.long()
    out = 0.0
    for idx, wgt in ((lo, 1.0 - t), (lo + 1, t)):
        inside = (idx >= 0) & (idx < n)
        g = torch.gather(src, axis, idx.clamp(0, n - 1).unsqueeze(-1)
                         .expand(-1, -1, -1, c))
        out = out + g * (wgt * inside).unsqueeze(-1)
    return out


def warp(images: torch.Tensor, zoom, theta, tx, ty, flip) -> torch.Tensor:
    """float ``[B, H, W, C]`` square images through their inverse affines,
    the quarter turns taken off first."""
    _, h, w, _ = images.shape
    q = torch.remainder(-torch.round(theta / (math.pi / 2.0)), 4.0).long()
    rotated = images
    for k in (1, 2, 3):
        rotated = torch.where((q == k).view(-1, 1, 1, 1),
                              torch.rot90(images, k, dims=(1, 2)), rotated)
    cos, sin = torch.cos(theta), torch.sin(theta)
    # The inverse map p_in = A (p_out - c - t) + c, A = zoom R(theta) with
    # the flip on x; then the quarter turn's rotation applied on the left.
    a = torch.stack([torch.stack([cos * zoom * flip, sin * zoom], -1),
                     torch.stack([-sin * zoom * flip, cos * zoom], -1)], 1)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    qc = torch.where(q == 0, one, torch.where(q == 2, -one, zero))
    qs = torch.where(q == 1, one, torch.where(q == 3, -one, zero))
    rot = torch.stack([torch.stack([qc, qs], -1),
                       torch.stack([-qs, qc], -1)], 1)
    a = torch.bmm(rot, a)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    px, py = cx + tx, cy + ty
    a11, a12 = a[:, 0, 0], a[:, 0, 1]
    a21, a22 = a[:, 1, 0], a[:, 1, 1]
    b1 = cx - (a11 * px + a12 * py)
    b2 = cy - (a21 * px + a22 * py)
    view = (-1, 1, 1)
    a11, a12, a21, a22, b1, b2 = (v.view(view)
                                  for v in (a11, a12, a21, a22, b1, b2))
    xs = torch.arange(w, dtype=torch.float32, device=images.device)
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    xs, ys = xs.view(1, 1, w), ys.view(1, h, 1)
    # x pass: u(x, y) with the y pass's source row v = y substituted.
    u = ((a11 - a12 * a21 / a22) * xs + (a12 / a22) * ys
         + (b1 - a12 * b2 / a22))
    tmp = _interp(rotated, u.expand(-1, h, w), 2)
    return _interp(tmp, (a21 * xs + a22 * ys + b2).expand(-1, h, w), 1)


def augment(images_u8: torch.Tensor, generator: torch.Generator,
            params: dict) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> augmented float32 in [0, 255]."""
    x = images_u8.to(torch.float32)
    b, h, w, _ = x.shape
    if h != w or max(h, w) > 160 or params["zoom"] > 0.5:
        raise ValueError("the reference resamples square frames of up to "
                         "160 pixels with zoom ranges up to 0.5")
    zoom, theta, tx, ty, flip, delta = draw_parts(generator, b, (h, w),
                                                  params, x.device)
    x = warp(x, zoom, theta, tx, ty, flip)
    if params["brightness"]:
        x = torch.clamp(x + delta, 0.0, 255.0)
    return x


def params_from_config(aug: dict) -> dict:
    """The parts' ranges from a ``config.yml`` ``DATA_AUG`` section."""
    return dict(zoom=float(aug.get("ZOOM_RANGE", 0.0)),
                shift_w=float(aug.get("WIDTH_SHIFT_RANGE", 0.0)),
                shift_h=float(aug.get("HEIGHT_SHIFT_RANGE", 0.0)),
                rotation=float(aug.get("ROTATION_RANGE", 0.0)),
                brightness=float(aug.get("BRIGHTNESS_RANGE", 0.0)),
                horizontal_flip=bool(aug.get("HORIZONTAL_FLIP", False)))
