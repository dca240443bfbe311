"""Depthwise convolution on the GPU: kernel ``csrc/depthwise.cu``.

It replaces the JAX package's TPU kernel
``ops/depthwise_pallas.py::_kernel``: a K x K depthwise conv at stride 1
with zero ``SAME`` padding, odd K up to 7, bfloat16 or float32 NHWC input,
float32 accumulation and output in the input's dtype. The TPU kernel
shift-MACs whole (W-sublane x C-lane) tiles in VMEM and groups its terms by
column shift to save sublane relayouts; on the GPU persistent blocks copy
each tile's input window into shared memory while they compute the
previous tile, and each thread computes several output rows of one
16-byte vector of channels, reusing each input row it reads for every
output row it touches (see the note at the top of the source). See
``ops/depthwise.py`` for the entry point and the plain version.

:func:`cuda_depthwise` takes the graph's NCHW tensor whose memory is NHWC
(``channels_last``); any other layout is copied to it first, and
:data:`copy_count` counts those copies. The weight comes repacked once per
layer to float32 ``[K, K, C]`` (:func:`pack_weight`). The output is NHWC
memory, returned as the NCHW view, on PyTorch's current stream.
:func:`launch_geometry` decides how the kernel's threads tile the output.
A launch reads nothing back to the host and allocates only its output,
so a CUDA graph's capture records it (``train/graphed.py``); a layer's
packed weight is then packed inside the graph, and the backward stays
the grouped conv's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from ab_line_classifier_torch.ops._build import DTYPES, Kernel

#: Inputs :func:`cuda_depthwise` had to copy to channels_last memory (its
#: launches are counted in ``ops/launches.py``).
copy_count = 0

#: Threads per block at most (the kernel's ``__launch_bounds__``).
MAX_THREADS = 256
#: Output rows per thread the kernel is built for.
ROWS = (4, 8)
#: Shared memory a block of the tiled kernel may take (two window buffers),
#: so that at least two blocks fit on an SM.
SMEM_MAX = 96 * 1024


_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("depthwise", "depthwise",
                ablc_depthwise=[_p, _p, _p] + [_i] * 14 + [_p])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How the kernel's threads tile an NHWC ``[b, h, w, c]`` output.

    The output is cut into ``b * row_tiles * col_tiles * ch_tiles`` tiles
    of ``rows`` rows x ``block[1]`` columns x ``block[0]`` channel vectors
    of ``vec`` channels, numbered channel tile fastest, then column tile,
    row tile and frame. Thread ``(tx, ty)`` of the block that takes tile
    ``(frame, rt, wt, ct)`` computes rows ``rt * rows ..`` of column ``xo =
    wt * block[1] + ty``, channels ``(ct * block[0] + tx) * vec ..``; a
    thread past ``w`` or ``c`` computes nothing, and rows past ``h`` are
    not written. ``vec`` 1 is the scalar kernel (one block per tile), else
    the tiled one, whose blocks take ``smem`` bytes of shared memory."""

    vec: int
    rows: int
    block: Tuple[int, int]
    row_tiles: int
    col_tiles: int
    ch_tiles: int
    smem: int

    def count(self, b: int) -> int:
        return b * self.row_tiles * self.col_tiles * self.ch_tiles


def _tiles(n: int, most: int) -> Tuple[int, int]:
    """``(count, size)``: the fewest tiles of at most ``most`` that cover
    ``n``, as even as they come."""
    count = -(-n // most)
    return count, -(-n // count)


@functools.lru_cache(maxsize=256)
def launch_geometry(b: int, h: int, w: int, c: int, k: int, itemsize: int,
                    aligned: bool, rows: int = 0, threads: int = 0,
                    cols: int = 0) -> Geometry:
    """The kernel's tiling of a ``[b, h, w, c]`` output for a K x K
    filter. The tiled kernel, one 16-byte vector of channels a thread, when
    ``aligned`` (x, y and the weight on 16-byte boundaries) and ``c`` is a
    whole number of vectors; else the scalar kernel, one channel a thread.
    A block spans ``min(w, cols)`` columns or more, then as many channel
    vectors as ``threads`` allows, with fewer threads where the tiled
    kernel's two window buffers would pass :data:`SMEM_MAX`. Unless the
    arguments say otherwise: 8 rows a thread, 256 threads and 8 columns a
    block; but 4 rows, 128 threads and 16 columns for frames of at most 4
    rows and for K >= 5 (fewer registers, less zero padding in the
    window). The defaults were picked on an H100 by
    ``scripts/torch_depthwise_tiles.py`` over the zoo's shapes. Cached: a
    model asks for the same few shapes on every forward."""
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    rows = rows or (4 if h <= 4 or k >= 5 else 8)
    threads = threads or (256 if rows == 8 else 128)
    cols = cols or (8 if rows == 8 else 16)
    if rows not in ROWS or not 0 < threads <= MAX_THREADS or k % 2 != 1:
        raise ValueError(f"rows {rows}, threads {threads}, K {k}: the kernel "
                         f"takes rows in {ROWS}, at most {MAX_THREADS} "
                         f"threads and odd K")
    while True:
        ch_tiles, bx = _tiles(c // vec, max(1, threads // min(w, cols)))
        col_tiles, by = _tiles(w, threads // bx)
        smem = 0 if vec == 1 else (2 * (rows + k - 1) * min(by + k - 1, w)
                                   * bx * 16)
        if smem <= SMEM_MAX:
            break
        threads //= 2
    g = Geometry(vec, rows, (bx, by), -(-h // rows), col_tiles, ch_tiles,
                 smem)
    if g.count(b) >= 2 ** 31:
        raise ValueError(f"shape {(b, h, w, c)} exceeds the grid")
    return g


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``[C, 1, K, K]`` depthwise weight -> contiguous float32 ``[K, K, C]``
    (the taps of one (dh, dw) contiguous over channels)."""
    c, _, k, kw = w.shape
    return (w.detach().to(torch.float32).permute(2, 3, 0, 1)
            .reshape(k, kw, c).contiguous())


def launch(xh: torch.Tensor, packed: torch.Tensor, y: torch.Tensor,
           geom: Geometry) -> None:
    """Launch the kernel on contiguous NHWC ``xh`` into ``y`` (same shape
    and dtype) with ``geom``; raises if the launch fails."""
    b, h, w, c = xh.shape
    KERNEL.launch("ablc_depthwise", xh.device, xh.data_ptr(),
                  packed.data_ptr(), y.data_ptr(),
                  int(xh.dtype == torch.bfloat16), packed.shape[0], geom.vec,
                  geom.rows, b, h, w, c, geom.row_tiles, geom.col_tiles,
                  geom.ch_tiles, *geom.block, geom.smem)


def cuda_depthwise(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA ``[B, C, H, W]`` tensor with a packed
    ``[K, K, C]`` float32 weight (stride 1, zero ``SAME`` padding)."""
    global copy_count

    if x.device.type != "cuda":
        raise ValueError(f"cuda_depthwise needs a CUDA tensor, got "
                         f"{x.device}")
    if x.ndim != 4 or x.dtype not in DTYPES:
        raise ValueError(f"expected a float32 or bfloat16 [B, C, H, W] "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    k = packed.shape[0]
    if (packed.dtype != torch.float32 or tuple(packed.shape) != (k, k, c)
            or not packed.is_contiguous() or packed.device != x.device):
        raise ValueError(f"packed weight must be contiguous float32 "
                         f"[K, K, {c}] on {x.device}, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if k % 2 != 1 or k > 7:
        raise ValueError(f"kernel size {k}: the kernel takes odd K <= 7")
    if b * h >= 2 ** 31 or w * c >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the grid")
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        xh = xh.contiguous()
        copy_count += 1
    y = torch.empty_like(xh)
    if y.numel() == 0:
        return y.permute(0, 3, 1, 2)
    aligned = all(t.data_ptr() % 16 == 0 for t in (xh, packed, y))
    launch(xh, packed, y,
           launch_geometry(b, h, w, c, k, x.element_size(), aligned))
    return y.permute(0, 3, 1, 2)
