"""Fused preprocessing on the GPU: uint8 frames -> model input in one pass.

Kernel ``csrc/preprocess.cu`` replaces the JAX package's TPU kernel
``ops/preprocess_pallas.py::_preprocess_kernel``.
The TPU kernel resizes with two 0/1 selection matmuls because the TPU has
no vector gather; on the GPU the kernel gathers each output pixel's three
source bytes. It is bound by bytes moved: one read of the source sectors
the index map selects and one write of the output, in contiguous NHWC,
which ``permute(0, 3, 1, 2)`` turns into the channels_last tensor the
convolutions read. What held its first version under that bound at small
sources was the transfers, not the bytes: one block per output row
(262,144 blocks at 2048 x 128x128), index loads ahead of every pixel load,
byte loads and 2-byte stores. Now blocks take stages of a few consecutive
rows over a grid of a few waves; each thread computes its columns' source
indices once; where the map touches most of a row's sectors, the rows are
staged in shared memory by bulk copies (TMA) into a ring of buffers, and
each stage's output leaves by one bulk store (see the note at the top of
the source).

:func:`launch_plan` decides all of that from the shapes (the row span,
staged or gathered, rows a stage, stages in the ring, threads, shared
memory, grid), :func:`row_window` is the kernel's per-row window
arithmetic and :func:`kernel_index` its index arithmetic;
``tests/test_torch_preprocess_plan.py`` holds them on the CPU, and
``scripts/torch_preprocess_tune.py`` sweeps the plan's knobs on the card.
The wrapper makes the plan and the kernel's argument block once per
shape, batch and options (over LATENCY_ROWS output rows, the grid sized
by the runtime's count of the blocks an SM holds), so a call after the
first is one dictionary lookup and one launch.

:func:`preprocess_frames` launches the kernel for a CUDA tensor and runs
the plain version (``ops/image.py::fused_preprocess``) for a CPU tensor.
A CUDA tensor never falls back: the kernel runs or the call raises. A
launch reads the host nothing back and allocates only its output, on the
current stream, so a CUDA graph's capture records it (the graphed
epochs' validation step, ``train/graphed.py``); the plan is made at the
first call for a shape, which a capture's eager warm-up makes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch.models.preprocess import preprocess_affine_params
from ab_line_classifier_torch.ops._build import Kernel
from ab_line_classifier_torch.ops.image import (UI_BLANK_HW, fused_preprocess,
                                                nearest_indices)

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}

#: The H100 SXM's streaming multiprocessors (the plan's default; the
#: wrapper asks the device).
SMS = 132
#: Threads per block at most (the kernel's ``__launch_bounds__``).
MAX_THREADS = 256
#: Dynamic shared memory a block may take: under 48 KB no attribute has to
#: be set before a launch (or a capture) may use it.
SMEM_MAX = 48 * 1024
#: Small batches, where the kernel takes a few microseconds and the
#: latency of the first byte decides, gather from global memory (no
#: staging: nothing to overlap). Up to LATENCY_ROWS output rows, a thread
#: takes one pixel where an output row's pixels lie far apart in the
#: source (more than two source columns apart: lanes on neighbouring
#: pixels share cache lines), else 48-byte units; where a block would take
#: a single row (up to FEW_ROWS_PER_SM rows an SM), one pixel a thread
#: whatever the map. These are the fastest paths that
#: scripts/torch_preprocess_tune.py measured at 1 and 64 x 128x128 and at
#: 64 x 1080x1440 (PERF.md).
LATENCY_ROWS = 8192
FEW_ROWS_PER_SM = 8
#: Shared memory of an SM that blocks can use, and what the runtime keeps
#: per block.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
#: Rows a stage, stages in the ring and waves of blocks
#: (scripts/torch_preprocess_tune.py, which sets them in turn: small stages
#: in a ring of two, over sixteen waves, were the fastest at the larger
#: path shapes; PERF.md), gathered rows a stage at most, and stages in the
#: ring at most (the kernel's kMaxStages).
GROUP = 2
STAGES = 2
WAVES = 16
MAX_GROUP = 16
MAX_STAGES = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True, eq=False)
class PreprocessPlan:
    """How the kernel covers ``batch`` frames of ``src_hw`` -> ``out_hw``.

    A source row's selected bytes are ``[lo, hi)`` (``[lo_blank, hi)`` in a
    row of the UI box, whose first ``xb`` output columns are blanked and
    not read); output column x takes the pixel at byte ``lo +
    col_offsets[x]`` of source row ``row_table[y]`` (the kernel computes
    both tables' entries in float64 as ``nearest_indices`` does).
    ``staged``: each row's span, widened to 16-byte alignment, is copied
    into a ``slot``-byte buffer of shared memory (a ring of ``stages``
    buffers of ``group`` rows); else the bytes are gathered from global
    memory. ``vec``: a row is a whole number of 16-byte vectors, a thread
    computes ``pixels`` whole pixels (48 bytes) at a time and each stage
    leaves by one bulk store; else a thread computes and stores one pixel
    (``units`` a row). The rows are cut into ``total_stages`` stages of ``group`` rows;
    block b of ``grid`` takes stages b, b + grid, ...; the grid was sized
    for ``blocks_per_sm`` blocks on each SM at once."""

    rows: int
    lo: int
    hi: int
    lo_blank: int
    xb: int
    blank_h: int
    staged: bool
    slot: int
    group: int
    stages: int
    total_stages: int
    grid: int
    threads: int
    smem: int
    blocks_per_sm: int
    vec: bool
    pixels: int
    units: int
    row_table: np.ndarray
    col_offsets: np.ndarray


def launch_plan(src_hw: Tuple[int, int], out_hw: Tuple[int, int],
                resize_mode: str = "tf", *, batch: int = 1,
                out_dtype: torch.dtype = torch.float32,
                blank_ui_region: bool = False, sms: int = SMS,
                blocks_per_sm: Optional[int] = None,
                path: Optional[str] = None) -> PreprocessPlan:
    """The kernel's launch plan: pure arithmetic on the shapes (see
    :class:`PreprocessPlan`). Over LATENCY_ROWS output rows the grid is
    :data:`WAVES` times the blocks that fit on the card at once
    (``blocks_per_sm`` on each of ``sms``: the wrapper asks the runtime,
    else an estimate from threads and shared memory); up to LATENCY_ROWS,
    the estimate alone, as scripts/torch_preprocess_tune.py measured those
    plans. ``path`` (a key of :data:`PATHS`) takes that path instead of
    the plan's choice, so that a check can hold each path to the plain
    version."""
    hs, ws = src_hw
    hd, wd = out_hw
    if batch < 1 or min(hs, ws, hd, wd) < 1:
        raise ValueError(f"empty preprocess: batch {batch}, {src_hw} -> "
                         f"{out_hw}")
    if path is not None and path not in PATHS:
        raise ValueError(f"path {path!r} is not one of {tuple(PATHS)}")
    rows = batch * hd
    if rows >= 2 ** 31:
        raise ValueError(f"batch {batch} x {hd} output rows exceeds the grid")
    ridx = nearest_indices(hs, hd, resize_mode)
    cidx = nearest_indices(ws, wd, resize_mode).astype(np.int64)
    lo, hi = int(cidx[0]) * 3, (int(cidx[-1]) + 1) * 3
    blank_h, xb = 0, 0
    if blank_ui_region:
        blank_h = min(UI_BLANK_HW[0], hs)
        xb = int(np.searchsorted(cidx, min(UI_BLANK_HW[1], ws)))
    lo_blank = int(cidx[xb]) * 3 if xb < wd else hi

    # Staged where the selected bytes touch at least half the sectors of
    # the span (sectors of a row that starts on a sector).
    touched = np.unique((cidx[:, None] * 3 + np.arange(3)) // 32).size
    window = _ceil(hi, 32) - lo // 32
    if path is None and rows <= LATENCY_ROWS:
        blocks_per_sm = None
        path = ("gathered" if rows > FEW_ROWS_PER_SM * sms and ws <= 2 * wd
                else "scalar")
    elif path is None:
        path = "staged" if 2 * touched >= window else "gathered"

    ppu = 48 // (3 * _ITEMSIZE[out_dtype])
    # Rows of whole 16-byte vectors go out by bulk stores of a stage,
    # double-buffered in shared memory: rows too long for that take the
    # scalar branch.
    vec = (path != "scalar" and wd % ppu == 0
           and 2 * wd * 3 * _ITEMSIZE[out_dtype] <= SMEM_MAX)
    pixels = ppu if vec else 1
    units = wd // pixels
    slot = _ceil(hi - lo, 16) * 16 + 16
    # A row of a stage takes a slot and a 16-byte row state in each staged
    # buffer, and (vec) two rows of output (a stage is stored while the
    # next is computed).
    row_out = 2 * wd * 3 * _ITEMSIZE[out_dtype] if vec else 0
    fit = (SMEM_MAX - 8 * MAX_STAGES) // (2 * (slot + 16) + row_out)
    staged = path == "staged" and vec and fit >= 1
    if staged:
        group = max(1, min(GROUP, fit))
        stages = max(2, min(STAGES, MAX_STAGES,
                            (SMEM_MAX - 8 * MAX_STAGES - group * row_out)
                            // (group * (slot + 16))))
    else:
        group = min(max(1, MAX_THREADS // units), MAX_GROUP)
        stages = 0
        if group * row_out > SMEM_MAX:
            group = SMEM_MAX // row_out

    def block(g):
        n = min(MAX_THREADS, max(32, _ceil(g * units, 32) * 32))
        smem = ((8 * MAX_STAGES + stages * g * (slot + 16) if staged else 0)
                + g * row_out)
        return smem, n

    smem, n_threads = block(group)
    if blocks_per_sm is None:
        blocks_per_sm = min(2048 // n_threads, 32,
                            SMEM_PER_SM // (smem + SMEM_RESERVED))
    # Enough stages to fill the card once: one row a stage where the rows
    # are few (a batch of one frame takes a block per output row).
    group = max(1, min(group, rows // (sms * blocks_per_sm)))
    smem, n_threads = block(group)
    total = _ceil(rows, group)
    return PreprocessPlan(
        rows=rows, lo=lo, hi=hi, lo_blank=lo_blank, xb=xb, blank_h=blank_h,
        staged=staged, slot=slot if staged else 0, group=group, stages=stages,
        total_stages=total, grid=min(total, sms * blocks_per_sm * WAVES),
        threads=n_threads, smem=smem, blocks_per_sm=blocks_per_sm, vec=vec,
        pixels=pixels, units=units, row_table=ridx.astype(np.int32),
        col_offsets=(cidx * 3 - lo).astype(np.int32))


def row_window(plan: PreprocessPlan, row_addr: int, sy: int):
    """The kernel's window of source row ``sy`` that starts at address
    ``row_addr``: ``(w0, nchunks, delta, xb)``. The staged copy is the
    ``nchunks`` 16-byte chunks from the aligned ``w0``; the byte at span
    offset ``o`` (address ``row_addr + lo + o``) lands at buffer index ``o
    + delta``; the row's first ``xb`` output columns are blanked."""
    blank = sy < plan.blank_h
    lo = plan.lo_blank if blank else plan.lo
    w0 = (row_addr + lo) & ~15
    nchunks = ((((row_addr + plan.hi + 15) & ~15) - w0) >> 4
               if lo < plan.hi else 0)
    return w0, nchunks, row_addr + plan.lo - w0, plan.xb if blank else 0


def kernel_index(i: int, src: int, dst: int, mode: str) -> int:
    """The kernel's source index of output index ``i`` (``src_index`` in
    ``csrc/preprocess.cu``): the float64 operations of
    ``ops/image.py::nearest_indices``, each rounded once, so the same
    index."""
    scale = src / dst
    x = float(i) if mode == "cv2" else float(i) + 0.5
    return min(math.floor(x * scale), src - 1)


class _Params(ctypes.Structure):
    """``struct Params`` of ``csrc/preprocess.cu``, field for field."""

    _fields_ = [("scale_h", ctypes.c_double), ("scale_w", ctypes.c_double),
                ("rows", ctypes.c_longlong), ("src_bytes", ctypes.c_longlong),
                *((name, ctypes.c_int) for name in (
                    "hs", "ws", "hd", "wd", "cv2", "lo", "hi", "lo_blank",
                    "xb", "blank_h", "slot", "group", "stages", "threads",
                    "smem", "grid", "total_stages", "dg", "du", "staged",
                    "vec", "out_is_bf16", "bgr")),
                ("scale", ctypes.c_float * 3), ("bias", ctypes.c_float * 3)]


_p = ctypes.c_void_p
KERNEL = Kernel("preprocess", "preprocess",
                ablc_preprocess=[_p] * 5,
                ablc_preprocess_blocks_per_sm=[_p])


#: The kernel's paths: rows staged in shared memory or gathered from global
#: memory, in 48-byte units with bulk stores, and the scalar branch
#: (gathered, one pixel a thread storing its own values). The plan picks
#: one; a check takes each through ``plan_launch(..., path=...)`` and
#: :func:`launch`. A path the shape cannot take (staging a span wider than
#: shared memory, bulk stores of rows off the 16-byte grid) falls back to
#: one it can.
PATHS = ("staged", "gathered", "scalar")

# (batch, hs, ws, hd, wd, resize, preprocess mode, out dtype, blank,
# device) -> its LaunchArgs
_launches: Dict[tuple, "LaunchArgs"] = {}


class LaunchArgs:
    """The kernel's argument block for one plan."""

    def __init__(self, plan, src_hw, batch, resize_mode, preprocess_mode,
                 out_dtype):
        hs, ws = src_hw
        hd, wd = plan.row_table.size, plan.col_offsets.size
        perm, scale, bias = preprocess_affine_params(preprocess_mode)
        if tuple(perm) not in ((0, 1, 2), (2, 1, 0)):
            raise ValueError(f"channel order {tuple(perm)} is neither RGB "
                             f"nor BGR")
        self.params = _Params(
            scale_h=hs / hd, scale_w=ws / wd, rows=plan.rows,
            src_bytes=batch * hs * ws * 3, hs=hs, ws=ws, hd=hd, wd=wd,
            cv2=int(resize_mode == "cv2"), lo=plan.lo, hi=plan.hi,
            lo_blank=plan.lo_blank, xb=plan.xb, blank_h=plan.blank_h,
            slot=plan.slot, group=plan.group, stages=plan.stages,
            threads=plan.threads, smem=plan.smem, grid=plan.grid,
            total_stages=plan.total_stages, dg=plan.threads // plan.units,
            du=plan.threads % plan.units, staged=int(plan.staged),
            vec=int(plan.vec), out_is_bf16=int(out_dtype == torch.bfloat16),
            bgr=int(perm[0] == 2),
            scale=(ctypes.c_float * 3)(*(float(s) for s in scale)),
            bias=(ctypes.c_float * 3)(*(float(x) for x in bias)))
        self.ref = ctypes.byref(self.params)


def plan_launch(batch, src_hw, out_hw, resize_mode, preprocess_mode,
                out_dtype, blank_ui_region, device,
                path: Optional[str] = None):
    """``(plan, LaunchArgs)`` for a launch on ``device``: the plan made
    again with the runtime's count of blocks that fit on an SM (registers
    included) for its kernel instance, threads and shared memory, which
    sizes the grid where :func:`launch_plan` uses it. ``path`` goes to
    :func:`launch_plan`."""
    kw = dict(batch=batch, out_dtype=out_dtype,
              blank_ui_region=blank_ui_region,
              sms=torch.cuda.get_device_properties(
                  device).multi_processor_count, path=path)
    plan = launch_plan(src_hw, out_hw, resize_mode, **kw)
    args = LaunchArgs(plan, src_hw, batch, resize_mode, preprocess_mode,
                      out_dtype)
    fit = KERNEL.query("ablc_preprocess_blocks_per_sm", device, args.ref)
    if fit < 1:
        raise RuntimeError(f"no block of {plan.threads} threads and "
                           f"{plan.smem} bytes fits on an SM")
    if fit != plan.blocks_per_sm:
        plan = launch_plan(src_hw, out_hw, resize_mode, blocks_per_sm=fit,
                           **kw)
        args = LaunchArgs(plan, src_hw, batch, resize_mode, preprocess_mode,
                          out_dtype)
    return plan, args


def launch(frames: torch.Tensor, out: torch.Tensor, args: LaunchArgs,
           mask: Optional[torch.Tensor] = None, count: bool = False) -> None:
    """One launch on contiguous ``frames`` into ``out`` (the shapes, dtype
    and device ``args`` was made for; ``out`` 16-byte aligned), on the
    current stream; raises if the launch fails. Counted only where
    ``count``: :func:`cuda_preprocess`'s launches are."""
    KERNEL.launch("ablc_preprocess", frames.device, frames.data_ptr(),
                  out.data_ptr(), None if mask is None else mask.data_ptr(),
                  args.ref, count=count)


def cuda_preprocess(frames: torch.Tensor, *,
                    out_hw: Tuple[int, int] = (128, 128),
                    preprocess_mode: str = "scale", resize_mode: str = "tf",
                    mask=None, out_dtype: torch.dtype = torch.float32,
                    blank_ui_region: bool = False) -> torch.Tensor:
    """Launch the kernel on a CUDA uint8 ``[B, H, W, 3]`` (or ``[H, W, 3]``)
    tensor, on the current stream. ``mask`` is a ``[H, W]`` beam mask at
    source resolution (0/1 values; see the module note)."""
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
    # A fresh allocation: 16-byte aligned, as the kernel's vector stores
    # need.
    out = torch.empty((b, hd, wd, 3), dtype=out_dtype, device=dev)
    if b == 0:
        return out[0] if squeeze else out
    key = (b, hs, ws, hd, wd, resize_mode, preprocess_mode, out_dtype,
           blank_ui_region, dev)
    args = _launches.get(key)
    if args is None:
        args = _launches[key] = plan_launch(
            b, (hs, ws), (hd, wd), resize_mode, preprocess_mode, out_dtype,
            blank_ui_region, dev)[1]
    m = None
    if mask is not None:
        m = torch.as_tensor(mask, device=dev).to(torch.float32).contiguous()
        if tuple(m.shape) != (hs, ws):
            raise ValueError(f"mask shape {tuple(m.shape)} != source "
                             f"{(hs, ws)}")
    launch(frames, out, args, m, count=True)
    return out[0] if squeeze else out


def preprocess_frames(frames: torch.Tensor, **kwargs) -> torch.Tensor:
    """The serving entry point: the CUDA kernel for a CUDA tensor, the plain
    PyTorch version for a CPU tensor. Keyword arguments as
    :func:`ab_line_classifier_torch.ops.image.fused_preprocess`."""
    if frames.device.type == "cpu":
        return fused_preprocess(frames, **kwargs)
    return cuda_preprocess(frames, **kwargs)
