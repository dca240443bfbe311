"""PyTorch port, kernel B1's launch plan on the CPU.

``ops/preprocess_cuda.launch_plan`` decides from the shapes alone how
``csrc/preprocess.cu`` covers a batch (each source row's byte span,
staged in shared memory or gathered from global memory, rows per stage
and per block, threads, shared memory, grid), and ``row_window`` is the
kernel's per-row window arithmetic. These tests hold them for both resize
maps and the source sizes the port meets (serving and Grad-CAM at
128x128, frames of 480x640, an odd 601x803, deploy clips of 1080x1440, a
4K source, an upsampling 64x64 and a 1x1 frame), and emulate the kernel in
numpy: bytes staged by the plan's windows (the 16-byte chunks inside the
tensor by one bulk copy, single bytes where its ends cut a chunk), gathered through the
plan's span-relative column offsets, the affine as float32 rounded
multiplies and add. The emulation must equal the plain version
``ops/image.py::fused_preprocess`` bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

from ab_line_classifier_torch.models.preprocess import preprocess_affine_params
from ab_line_classifier_torch.ops import preprocess_cuda as PC
from ab_line_classifier_torch.ops.image import (UI_BLANK_HW, fused_preprocess,
                                                nearest_indices)

OUT_HW = (128, 128)
# (source, output)
SHAPES = [((128, 128), OUT_HW), ((480, 640), OUT_HW), ((601, 803), OUT_HW),
          ((1080, 1440), OUT_HW), ((2160, 3840), OUT_HW),
          ((64, 64), OUT_HW), ((1, 1), OUT_HW)]
CASES = [(src, out, resize) for (src, out), resize in
         itertools.product(SHAPES, ("tf", "cv2"))]
IDS = [f"{s[0]}x{s[1]}-{r}" for s, _, r in CASES]
# Where the batch starts: on the 16-byte grid, and off it (a contiguous
# slice frames[1:] of odd-sized frames).
BASES = (1 << 20, (1 << 20) + 1, (1 << 20) + 13)


def _selected(plan, sy):
    """Span offsets of the bytes row ``sy`` reads: every pixel's 3 bytes
    past the blanked columns."""
    xb = plan.xb if sy < plan.blank_h else 0
    return (plan.col_offsets[xb:, None] + np.arange(3)).ravel()


def _copies(plan, row_addr, sy, begin, end):
    """The staged copy of one row as the kernel makes it: (w0, addresses of
    the 16-byte chunks its bulk copy covers, addresses copied byte by
    byte)."""
    w0, n, _, _ = PC.row_window(plan, row_addr, sy)
    chunks, single = [], []
    for k in range(n):
        ga = w0 + 16 * k
        if ga >= begin and ga + 16 <= end:
            chunks.append(ga)
        else:
            single.extend(a for a in range(ga, ga + 16) if begin <= a < end)
    return w0, chunks, single


@pytest.mark.parametrize("src,out,resize", CASES, ids=IDS)
@pytest.mark.parametrize("blank", (False, True))
def test_windows_cover_the_selected_bytes_inside_the_tensor(src, out, resize,
                                                            blank):
    plan = PC.launch_plan(src, out, resize, batch=2, blank_ui_region=blank,
                          path="staged")
    hs, ws = src
    assert plan.staged and plan.slot % 16 == 0
    for base in BASES:
        begin, end = base, base + 2 * hs * ws * 3
        for b, sy in itertools.product(range(2), np.unique(plan.row_table)):
            row = begin + (b * hs + int(sy)) * ws * 3
            w0, n, delta, _ = PC.row_window(plan, row, int(sy))
            assert w0 % 16 == 0 and n * 16 <= plan.slot
            w0, chunks, single = _copies(plan, row, int(sy), begin, end)
            assert all(a % 16 == 0 for a in chunks)
            copied = set(single)
            for a in chunks:
                copied.update(range(a, a + 16))
            assert min(copied, default=begin) >= begin
            assert max(copied, default=begin) < end
            need = row + plan.lo + _selected(plan, int(sy))
            assert copied.issuperset(need.tolist())
            # The buffer index of each needed byte lies in the slot.
            idx = _selected(plan, int(sy)) + delta
            assert idx.size == 0 or (idx.min() >= 0
                                     and idx.max() < n * 16 <= plan.slot)


@pytest.mark.parametrize("src,out,resize", CASES, ids=IDS)
def test_path_follows_the_sector_density(src, out, resize):
    plan = PC.launch_plan(src, out, resize, batch=2048)
    # The identity map, 480x640, 601x803 and 1080x1440 touch most sectors
    # of their span; a 4K source to 128 touches about a third.
    assert plan.staged == (src != (2160, 3840))
    cidx = plan.col_offsets.astype(np.int64) + plan.lo
    assert np.all(np.diff(cidx) >= 0)
    assert plan.lo == cidx[0] and plan.hi == cidx[-1] + 3


@pytest.mark.parametrize("src,out,resize", CASES, ids=IDS)
@pytest.mark.parametrize("out_dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_block_fits_and_the_grid_covers_every_row(src, out, resize,
                                                  out_dtype):
    for batch in (1, 7, 64, 2048):
        plan = PC.launch_plan(src, out, resize, batch=batch,
                              out_dtype=out_dtype, blank_ui_region=True)
        hd, wd = out
        # Staged: the mbarriers, and a row state and a slot for every row
        # of every stage in the ring; vec: two stages of output.
        item = 2 if out_dtype == torch.bfloat16 else 4
        assert plan.smem == (
            (8 * PC.MAX_STAGES + plan.stages * plan.group * (plan.slot + 16)
             if plan.staged else 0)
            + (2 * plan.group * wd * 3 * item if plan.vec else 0))
        assert 2 <= plan.stages <= PC.MAX_STAGES or not plan.staged
        assert plan.smem <= PC.SMEM_MAX
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        # Stages of group rows cover every row once; block b takes stages
        # b, b + grid, ...
        assert plan.total_stages == -(-plan.rows // plan.group)
        assert 1 <= plan.grid <= plan.total_stages
        if plan.vec:
            assert plan.units * plan.pixels == wd
            assert (wd * 3 * (2 if out_dtype == torch.bfloat16 else 4)) % 16 == 0
        else:
            assert plan.units == wd and plan.pixels == 1
        if batch == 1:
            # One frame still spreads over a block per output row.
            assert plan.grid >= hd and plan.group == 1
        if batch == 2048:
            # Waves of the blocks the card holds at once, each block a few
            # rows: not one block per output row.
            assert plan.grid <= PC.SMS * 32 * PC.WAVES
            assert plan.rows >= 3 * plan.grid


def test_scalar_branch_for_widths_off_the_vector():
    for wd, dtype, vec in ((128, torch.bfloat16, True), (124, torch.bfloat16,
                                                          False),
                           (124, torch.float32, True), (30, torch.float32,
                                                        False)):
        plan = PC.launch_plan((480, 640), (96, wd), "tf", batch=256,
                              out_dtype=dtype, path="staged")
        assert plan.vec == vec
    # A row whose two stages of output would not fit in shared memory.
    plan = PC.launch_plan((2160, 3840), (64, 4096), "tf", batch=64,
                          out_dtype=torch.float32)
    assert not plan.vec and plan.smem <= PC.SMEM_MAX


def test_small_batches_take_the_latency_paths():
    """Up to LATENCY_ROWS rows the plan gathers: one pixel a thread where a
    block would take a single row or where the map spreads an output row's
    pixels far apart in the source, else 48-byte units; a serving batch
    stages."""
    for batch in (1, 4):
        plan = PC.launch_plan((128, 128), OUT_HW, batch=batch,
                              out_dtype=torch.bfloat16)
        assert not plan.staged and not plan.vec and plan.pixels == 1
        assert plan.group == 1 and plan.grid == batch * OUT_HW[0]
    plan = PC.launch_plan((128, 128), OUT_HW, batch=64,
                          out_dtype=torch.bfloat16)
    assert not plan.staged and plan.vec and plan.pixels == 8
    plan = PC.launch_plan((1080, 1440), OUT_HW, "cv2", batch=64,
                          blank_ui_region=True)
    assert not plan.staged and not plan.vec
    for src, batch in (((128, 128), 2048), ((480, 640), 256)):
        plan = PC.launch_plan(src, OUT_HW, batch=batch,
                              out_dtype=torch.bfloat16)
        assert plan.staged and plan.vec and plan.pixels == 8


def test_runtime_occupancy_sizes_only_the_larger_plans():
    """Over LATENCY_ROWS rows the blocks an SM holds (the runtime's count)
    size the stages and the grid; up to it the plan keeps its own
    estimate; a forced path keeps the count it is given."""
    kw = dict(out_dtype=torch.bfloat16)
    big = [PC.launch_plan((480, 640), OUT_HW, batch=2048, blocks_per_sm=n,
                          **kw) for n in (4, 16)]
    assert big[0].blocks_per_sm == 4 and big[1].blocks_per_sm == 16
    assert big[0].grid < big[1].grid
    small = [PC.launch_plan((128, 128), OUT_HW, batch=64, blocks_per_sm=n,
                            **kw) for n in (None, 4, 16)]
    assert len({(p.group, p.grid, p.blocks_per_sm) for p in small}) == 1
    forced = PC.launch_plan((128, 128), OUT_HW, batch=64, blocks_per_sm=16,
                            path="gathered", **kw)
    assert forced.blocks_per_sm == 16


def test_unknown_path_raises():
    with pytest.raises(ValueError, match="path"):
        PC.launch_plan((128, 128), OUT_HW, batch=2, path="vector")


def _emulate(frames, plan, mode, base):
    """The kernel in numpy over ``frames`` laid out from address ``base``:
    float32 ``[B, hd, wd, 3]`` before the output cast."""
    b, hs, ws, _ = frames.shape
    hd, wd = plan.row_table.size, plan.col_offsets.size
    mem = frames.reshape(-1)
    begin, end = base, base + mem.size
    perm, scale, bias = preprocess_affine_params(mode)
    scale, bias = scale.astype(np.float32), bias.astype(np.float32)
    out = np.empty((b * hd, wd, 3), np.float32)
    for r in range(b * hd):
        f, y = divmod(r, hd)
        sy = int(plan.row_table[y])
        row = begin + (f * hs + sy) * ws * 3
        w0, n, delta, xb = PC.row_window(plan, row, sy)
        px = np.zeros((wd, 3), np.uint8)
        cols = plan.col_offsets[xb:, None] + np.asarray(perm)
        if plan.staged:
            buf = np.zeros(plan.slot, np.uint8)
            written = np.zeros(plan.slot, bool)
            _, chunks, single = _copies(plan, row, sy, begin, end)
            for a in chunks + single:
                size = 16 if a in chunks else 1
                buf[a - w0:a - w0 + size] = mem[a - begin:a - begin + size]
                written[a - w0:a - w0 + size] = True
            assert written[cols + delta].all()
            px[xb:] = buf[cols + delta]
        else:
            px[xb:] = mem[row + plan.lo + cols - begin]
        m = np.ones(wd, np.float32)
        m[:xb] = 0.0
        v = px.astype(np.float32) * scale
        out[r] = v * m[:, None] + bias
    return out.reshape(b, hd, wd, 3)


@pytest.mark.parametrize("src,out,resize", CASES, ids=IDS)
@pytest.mark.parametrize("blank", (False, True))
def test_emulated_kernel_equals_the_plain_version(src, out, resize, blank):
    hs, ws = src
    batch = 1 if hs * ws > 10 ** 6 else 3
    frames = np.random.RandomState(hs + ws).randint(
        0, 256, (batch, hs, ws, 3)).astype(np.uint8)
    for (mode, dtype, base), path in itertools.product(
            (("caffe", torch.bfloat16, BASES[1]),
             ("tf", torch.float32, BASES[2]),
             ("scale", torch.float32, BASES[0])), ("staged", "gathered")):
        plan = PC.launch_plan(src, out, resize, batch=batch, out_dtype=dtype,
                              blank_ui_region=blank, path=path)
        got = torch.from_numpy(_emulate(frames, plan, mode, base)).to(dtype)
        want = fused_preprocess(torch.from_numpy(frames), out_hw=out,
                                preprocess_mode=mode, resize_mode=resize,
                                out_dtype=dtype, blank_ui_region=blank)
        assert torch.equal(got, want), (mode, dtype, path)


def test_ui_box_columns_are_not_read():
    """A row of the UI box starts its span after the blanked columns."""
    plan = PC.launch_plan((1080, 1440), OUT_HW, "cv2", blank_ui_region=True)
    cidx = plan.col_offsets // 3 + plan.lo // 3
    assert plan.blank_h == UI_BLANK_HW[0]
    assert plan.xb == int((cidx < UI_BLANK_HW[1]).sum()) > 0
    assert plan.lo_blank == 3 * int(cidx[plan.xb]) > plan.lo
    # A frame narrower than the box: its rows in the box read nothing.
    plan = PC.launch_plan((128, 128), OUT_HW, "tf", blank_ui_region=True)
    assert plan.xb == OUT_HW[1] and plan.lo_blank == plan.hi
    assert PC.row_window(plan, 4096, 0)[1] == 0


@pytest.mark.parametrize("mode", ("tf", "cv2"))
def test_kernel_index_arithmetic_equals_the_index_map(mode):
    """The kernel computes each source index (no table): its float64
    arithmetic gives nearest_indices' indices at every size pair up to 300
    and at the sizes the port meets."""
    pairs = [(s, d) for s in range(1, 301) for d in range(1, 301, 7)]
    pairs += [(s, d) for s in (480, 601, 640, 803, 1080, 1440, 2160, 3840)
              for d in (1, 32, 96, 128, 224, 299, 300, 512)]
    for src, dst in pairs:
        want = nearest_indices(src, dst, mode)
        got = [PC.kernel_index(i, src, dst, mode) for i in range(dst)]
        assert got == want.tolist(), (src, dst)
