"""Fused preprocessing on the GPU: uint8 frames -> model input in one pass.

Kernel ``csrc/preprocess.cu`` replaces the JAX package's TPU kernel
``ops/preprocess_pallas.py::_preprocess_kernel``.
The TPU kernel resizes with two 0/1 selection matmuls because the TPU has
no vector gather; on the GPU each thread gathers its output pixel's three
source bytes directly, through row and column index vectors that the
wrapper computes once per ``(Hs, Ws, Hd, Wd, mode)`` and keeps on the
device. The kernel is bound by bytes moved: one read of the gathered source
pixels and one write of the output, in contiguous NHWC, which
``permute(0, 3, 1, 2)`` turns into the channels_last tensor the
convolutions read. It takes any source size.

:func:`preprocess_frames` launches the kernel for a CUDA tensor and runs
the plain version (``ops/image.py::fused_preprocess``) for a CPU tensor.
A CUDA tensor never falls back: the kernel runs or the call raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ab_line_classifier_torch.models.preprocess import preprocess_affine_params
from ab_line_classifier_torch.ops.image import (UI_BLANK_HW, fused_preprocess,
                                                nearest_indices)

#: Kernel launches since the last :func:`reset_launch_count`; only the
#: launch site below adds to it.
launch_count = 0

_indices: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _device_indices(src_hw, dst_hw, mode, device):
    key = (*src_hw, *dst_hw, mode, device)
    idx = _indices.get(key)
    if idx is None:
        idx = tuple(torch.as_tensor(nearest_indices(s, d, mode),
                                    dtype=torch.int32, device=device)
                    for s, d in zip(src_hw, dst_hw))
        _indices[key] = idx
    return idx


def _bind(lib: ctypes.CDLL):
    fn = lib.ablc_preprocess
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, ctypes.c_longlong, i, i, i, i, p, p, p,
                       i, i, i, i, i, f, f, f, f, f, f, p]
        fn.restype = i
        lib.ablc_error_string.argtypes = [i]
        lib.ablc_error_string.restype = ctypes.c_char_p
    return fn


def cuda_preprocess(frames: torch.Tensor, *,
                    out_hw: Tuple[int, int] = (128, 128),
                    preprocess_mode: str = "scale", resize_mode: str = "tf",
                    mask=None, out_dtype: torch.dtype = torch.float32,
                    blank_ui_region: bool = False) -> torch.Tensor:
    """Launch the kernel on a CUDA uint8 ``[B, H, W, 3]`` (or ``[H, W, 3]``)
    tensor, on the current stream. ``mask`` is a ``[H, W]`` beam mask at
    source resolution (0/1 values; see the module note)."""
    global launch_count
    from ab_line_classifier_torch.ops._build import load_library

    if frames.device.type != "cuda":
        raise ValueError(f"cuda_preprocess needs a CUDA tensor, got "
                         f"{frames.device}")
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    if (frames.ndim != 4 or frames.dtype != torch.uint8
            or frames.shape[-1] != 3):
        raise ValueError(f"expected uint8 [B, H, W, 3] frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous NHWC")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    b, hs, ws, _ = frames.shape
    hd, wd = out_hw
    if b * hd >= 2 ** 31:
        raise ValueError(f"batch {b} x {hd} output rows exceeds the grid")
    dev = frames.device
    out = torch.empty((b, hd, wd, 3), dtype=out_dtype, device=dev)
    if b == 0:
        return out[0] if squeeze else out
    ridx, cidx = _device_indices((hs, ws), (hd, wd), resize_mode, dev)
    m = None
    if mask is not None:
        m = torch.as_tensor(mask, device=dev).to(torch.float32).contiguous()
        if tuple(m.shape) != (hs, ws):
            raise ValueError(f"mask shape {tuple(m.shape)} != source "
                             f"{(hs, ws)}")
    blank_h, blank_w = ((min(UI_BLANK_HW[0], hs), min(UI_BLANK_HW[1], ws))
                        if blank_ui_region else (0, 0))
    perm, scale, bias = preprocess_affine_params(preprocess_mode)

    lib = load_library("preprocess")
    fn = _bind(lib)
    with torch.cuda.device(dev):
        rc = fn(frames.data_ptr(), out.data_ptr(),
                int(out_dtype == torch.bfloat16), b * hd, hs, ws, hd, wd,
                ridx.data_ptr(), cidx.data_ptr(),
                None if m is None else m.data_ptr(), blank_h, blank_w,
                *(int(p) for p in perm), *(float(s) for s in scale),
                *(float(x) for x in bias),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("preprocess kernel launch failed: "
                           + lib.ablc_error_string(rc).decode())
    launch_count += 1
    return out[0] if squeeze else out


def preprocess_frames(frames: torch.Tensor, **kwargs) -> torch.Tensor:
    """The serving entry point: the CUDA kernel for a CUDA tensor, the plain
    PyTorch version for a CPU tensor. Keyword arguments as
    :func:`ab_line_classifier_torch.ops.image.fused_preprocess`."""
    if frames.device.type == "cpu":
        return fused_preprocess(frames, **kwargs)
    return cuda_preprocess(frames, **kwargs)
