"""Image ops: nearest-neighbour resize semantics, the plain PyTorch
frame -> model-input preprocessing, and the auto-masking path's
anti-aliased downsample and bilinear resize (port of the JAX package's
``ops/image.py``).

Two index maps are supported, as in the reference:

* ``'tf'``  — half-pixel centres: ``src = floor((i + 0.5) * scale)`` (TF2
  nearest-neighbour default, used in training).
* ``'cv2'`` — OpenCV INTER_NEAREST: ``src = floor(i * scale)`` (used on the
  deploy path).

:func:`fused_preprocess` here is the plain version of the CUDA kernel in
``ops/preprocess_cuda.py``: the CPU tests and ``chip_smoke.py`` hold the
kernel against it, and the serving path only reaches it for CPU tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch.models.preprocess import (PREPROCESS_FNS,
                                                        preprocess_affine_params)

# WaveBase UI box zeroed by ``blank_ui_region`` (top-left rows x cols).
UI_BLANK_HW = (50, 160)


def nearest_indices(src: int, dst: int, mode: str = "tf") -> np.ndarray:
    """Source indices for a 1-D nearest-neighbour resize. The float64 numpy
    arithmetic is the reference's, kept exactly so both packages pick the
    same pixels."""
    scale = src / dst
    i = np.arange(dst, dtype=np.float64)
    if mode == "tf":
        idx = np.floor((i + 0.5) * scale)
    elif mode == "cv2":
        idx = np.floor(i * scale)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return np.clip(idx, 0, src - 1).astype(np.int32)


_nearest_index: Dict[tuple, torch.Tensor] = {}


def _index(src: int, dst: int, mode: str, device) -> torch.Tensor:
    """:func:`nearest_indices` on ``device``, made once per ``(src, dst,
    mode, device)``: a call after the first copies nothing from the host,
    so a CUDA graph can capture it."""
    key = (src, dst, mode, torch.device(device))
    idx = _nearest_index.get(key)
    if idx is None:
        idx = _nearest_index[key] = torch.as_tensor(
            nearest_indices(src, dst, mode), dtype=torch.long, device=device)
    return idx


_affine: Dict[tuple, Tuple[Optional[torch.Tensor], torch.Tensor,
                           torch.Tensor]] = {}


def _device_affine(preprocess_mode: str, device: torch.device):
    """:func:`preprocess_affine_params` on ``device`` (the channel
    permutation None where it is the identity), made once per ``(mode,
    device)``, as :func:`_index`."""
    key = (preprocess_mode, device)
    params = _affine.get(key)
    if params is None:
        perm, scale, bias = preprocess_affine_params(preprocess_mode)
        params = _affine[key] = (
            None if np.array_equal(perm, np.arange(3))
            else torch.as_tensor(perm, device=device),
            torch.as_tensor(scale, device=device),
            torch.as_tensor(bias, device=device))
    return params


def nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                   mode: str = "tf") -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) images by index gather."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (h, w) != (oh, ow):
        x = (x.index_select(1, _index(h, oh, mode, x.device))
             .index_select(2, _index(w, ow, mode, x.device)))
    return x[0] if squeeze else x


def antialias_sigma(src_hw: Tuple[int, int],
                    dst_hw: Tuple[int, int]) -> Tuple[float, float]:
    """skimage.transform.resize's default anti-aliasing sigma per axis:
    ``max(0, (downscale_factor - 1) / 2)`` (scikit-image 0.19.1, the
    reference's pin)."""
    return tuple(max(0.0, (s / d - 1.0) / 2.0)
                 for s, d in zip(src_hw, dst_hw))


def _gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d's kernel: radius
    ``int(truncate * sigma + 0.5)``, normalized Gaussian weights, computed
    in float64 and stored as float32."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


_gaussian_taps: Dict[tuple, torch.Tensor] = {}


def _device_gaussian_taps(sigma: float, truncate: float,
                          device: torch.device) -> torch.Tensor:
    """:func:`_gaussian_kernel1d` on ``device``, made once per ``(sigma,
    truncate, device)``: a call after the first copies nothing from the
    host, so a CUDA graph can capture it."""
    key = (sigma, truncate, device)
    k = _gaussian_taps.get(key)
    if k is None:
        k = _gaussian_taps[key] = torch.as_tensor(
            _gaussian_kernel1d(sigma, truncate), device=device)
    return k


def gaussian_blur(x: torch.Tensor, sigma_hw: Tuple[float, float],
                  truncate: float = 4.0) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of ``[B, H, W]`` images:
    ``scipy.ndimage.gaussian_filter(..., mode='grid-constant', cval=0)``,
    rows first, then columns, each pass a float32 convolution."""
    out = x.to(torch.float32)[:, None]
    for axis, sigma in ((0, float(sigma_hw[0])), (1, float(sigma_hw[1]))):
        if sigma <= 0.0:
            continue
        k = _device_gaussian_taps(sigma, float(truncate), x.device)
        r = (len(k) - 1) // 2
        if axis == 0:
            out = F.conv2d(out, k.view(1, 1, -1, 1), padding=(r, 0))
        else:
            out = F.conv2d(out, k.view(1, 1, 1, -1), padding=(0, r))
    return out[:, 0]


def linear_resize_weights(src: int, dst: int,
                          antialias: bool = True) -> np.ndarray:
    """``[src, dst]`` float32 weights of ``jax.image.resize(method=
    "linear")`` along one axis: half-pixel sample positions, a triangle
    kernel (widened by the downscale factor when ``antialias``), each
    column normalized to sum 1, and columns whose sample lies outside the
    source zeroed. Computed with JAX's float32 operations in JAX's order,
    so the weights that are exactly 0 are the same ones: a bilinear
    upsample's support (output > 0) depends only on those. For an odd
    multiple of 128 (640, 1920) half the outer taps are 0 only in exact
    arithmetic; ``F.interpolate`` rounds them otherwise."""
    scale = dst / src
    f32 = np.float32
    inv = f32(1.0 / scale)
    kscale = f32(max(1.0 / scale, 1.0)) if antialias else f32(1.0)
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


_resize_weights: Dict[tuple, torch.Tensor] = {}


def _device_resize_weights(src: int, dst: int, antialias: bool,
                           device: torch.device) -> torch.Tensor:
    """:func:`linear_resize_weights` on ``device``, made once per
    ``(src, dst, antialias, device)``: a call after the first copies
    nothing from the host, so a CUDA graph can capture it."""
    key = (src, dst, antialias, device)
    w = _resize_weights.get(key)
    if w is None:
        w = _resize_weights[key] = torch.as_tensor(
            linear_resize_weights(src, dst, antialias), device=device)
    return w


def linear_resize(x: torch.Tensor, out_hw: Tuple[int, int],
                  antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, (B,) + out_hw, method="linear", antialias=)``
    of ``[B, H, W]`` float32 images: one float32 product with each axis's
    :func:`linear_resize_weights` (an axis of equal size is left alone)."""
    x = x.to(torch.float32)
    h, w = x.shape[1:]
    if h != out_hw[0]:
        wh = _device_resize_weights(h, out_hw[0], antialias, x.device)
        x = torch.einsum("bhw,hi->biw", x, wh)
    if w != out_hw[1]:
        ww = _device_resize_weights(w, out_hw[1], antialias, x.device)
        x = torch.einsum("bhw,wj->bhj", x, ww)
    return x


def skimage_downsample(x: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """``skimage.transform.resize(..., mode='constant', preserve_range=True)``
    (scikit-image 0.19.1) of ``[B, H, W]`` float images: Gaussian
    anti-aliasing at the default sigma, then half-pixel point-bilinear
    interpolation with no second anti-aliasing."""
    sigma = antialias_sigma(tuple(x.shape[1:]), out_hw)
    if max(sigma) > 0.0:
        x = gaussian_blur(x, sigma)
    return linear_resize(x, out_hw, antialias=False)


def source_mask(src_hw: Tuple[int, int], mask=None,
                blank_ui_region: bool = False,
                device=None) -> Optional[torch.Tensor]:
    """The uint8 ``[Hs, Ws]`` multiplier applied at source resolution: the
    beam ``mask`` cast to uint8 (as the reference's XLA path does), times
    the UI-blank box. None when neither is requested."""
    hs, ws = src_hw
    m = None
    if blank_ui_region:
        m = torch.ones((hs, ws), dtype=torch.uint8, device=device)
        m[:min(UI_BLANK_HW[0], hs), :min(UI_BLANK_HW[1], ws)] = 0
    if mask is not None:
        mu8 = torch.as_tensor(mask, device=device).to(torch.uint8)
        m = mu8 if m is None else m * mu8
    return m


def fused_preprocess(frames: torch.Tensor, *,
                     out_hw: Tuple[int, int] = (128, 128),
                     preprocess_mode: str = "scale", resize_mode: str = "tf",
                     mask=None, out_dtype: torch.dtype = torch.float32,
                     blank_ui_region: bool = False) -> torch.Tensor:
    """uint8 NHWC (or HWC) RGB frames -> [UI blank] -> [beam-mask multiply]
    -> nearest resize -> float32 -> channelwise affine (+ BGR swap for
    caffe) -> ``out_dtype``.

    The mask is cast to uint8 before it multiplies the pixels, as the
    reference's XLA path does (the JAX package's ``ops/image.py:147``);
    its Pallas kernel and the CUDA kernel multiply by the float value
    instead. The two agree only for binary (0/1) masks, which is what the
    beam masks and the UI blank are.

    Here the pixels are gathered first and the resized mask multiplies the
    gathered pixels: a product commutes with a gather, so the result is
    the reference's bit for bit, without a full-resolution temporary.
    The affine runs as a rounded multiply then a rounded add in float32.
    """
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    if frames.dtype != torch.uint8 or frames.shape[-1] != 3:
        raise ValueError(f"expected uint8 [B, H, W, 3] frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    hs, ws = frames.shape[1], frames.shape[2]
    x = nearest_resize(frames, out_hw, resize_mode)
    m = source_mask((hs, ws), mask, blank_ui_region, frames.device)
    if m is not None:
        m = nearest_resize(m[..., None], out_hw, resize_mode)[..., 0]
        x = x * m[None, :, :, None]

    perm, scale, bias = _device_affine(preprocess_mode, x.device)
    if perm is not None:
        x = x[..., perm]
    x = x.to(torch.float32)
    x = x * scale + bias
    x = x.to(out_dtype)
    return x[0] if squeeze else x


# The option grid on which the CUDA kernel is held to this plain version
# (the port's tests and chip_smoke.py).
PREPROCESS_MODES = tuple(PREPROCESS_FNS)
RESIZE_MODES = ("tf", "cv2")
MASK_OPTIONS = ("none", "beam", "blank")
OUT_DTYPES = (torch.float32, torch.bfloat16)


def mask_kwargs(option: str, beam) -> dict:
    """:func:`fused_preprocess` mask arguments for a ``MASK_OPTIONS``
    entry; ``beam`` is the 0/1 beam mask used for ``"beam"``."""
    return dict(mask=beam if option == "beam" else None,
                blank_ui_region=option == "blank")


def max_ulp_error(got, want, out_dtype: torch.dtype,
                  preprocess_mode: str) -> float:
    """Max |got - want| of two preprocess outputs (tensors or arrays of one
    shape). Raises AssertionError where an element is beyond 1 ulp of
    ``out_dtype`` (float32 or bfloat16) taken at max(|want|, |bias[c]|).

    That is the kernel's equality rule: the affine ``x * scale + bias`` is
    a rounded multiply then a rounded add, and an FMA contraction on either
    side (the only difference allowed) moves the result by up to the
    product's rounding error even where the sum cancels to a small value.
    """
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}")
    got = torch.as_tensor(got).to(torch.float64)
    want = torch.as_tensor(want).to(device=got.device, dtype=torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    bias = torch.as_tensor(np.abs(preprocess_affine_params(preprocess_mode)[2]),
                           dtype=torch.float64, device=got.device)
    mag = torch.maximum(want.abs(), bias).clamp_min(2.0 ** -126)
    mantissa = 23 if out_dtype == torch.float32 else 7
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mantissa)
    err = (got - want).abs()
    bad = int((err > ulp).sum())
    if bad:
        raise AssertionError(f"{bad} elements beyond 1 {out_dtype} ulp; "
                             f"max abs err {float(err.max())}")
    return float(err.max())
