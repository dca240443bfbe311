#!/usr/bin/env python3
"""Tile sweep of the PyTorch port's depthwise kernel (B2,
``ab_line_classifier_torch/csrc/depthwise.cu``) on one NVIDIA GPU.

It prints ptxas's registers and spills and a static SASS histogram by
opcode of each bf16 kernel instance; then, for every distinct stride-1
depthwise shape of mobilenetv2 (batch 2048), xception and efficientnetb7
(batch 512), in bf16, it launches the kernel under each choice of rows per
thread, threads per block and columns per block that
``ops/depthwise_cuda.py::launch_geometry`` accepts, holds each against the
plain version (``torch.equal``), and prints its time (CUDA events) beside
cuDNN's grouped conv, a copy of the input, the kernel at K = 1 and the
bytes bound; the sums per model forward; and the SM clock, memory clock
and power that nvidia-smi sampled meanwhile. The default geometry is the
one marked ``*``. Run from the root of a checkout::

    python3 scripts/torch_depthwise_tiles.py
"""

import collections
import itertools
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MODELS = (("mobilenetv2", 2048), ("xception", 512), ("efficientnetb7", 512))
CHOICES = list(itertools.product((4, 8), (128, 256), (8, 16, 32)))


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ab_line_classifier_torch.ops import _build
    from ab_line_classifier_torch.ops import depthwise as D
    from ab_line_classifier_torch.ops import depthwise_cuda as DC
    from ab_line_classifier_torch.predict.benchmark import (
        build_zoo, depthwise_layer_shapes)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import chip_smoke

    lib = _build.build("depthwise")
    for inst, line in chip_smoke.ptxas_report(_build.build_log("depthwise")):
        print(f"ptxas {inst}: {line}", flush=True)
    for inst, total, ops in sass_histogram(lib):
        print(f"sass {inst}: {total} instructions: "
              + ", ".join(f"{op} {n}" for op, n in ops[:14]), flush=True)
    smi_log = open(os.path.join(REPO, "build", "smi.csv"), "w")
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"], stdout=smi_log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, batch in MODELS:
        counts = collections.Counter(depthwise_layer_shapes(build_zoo(name)))
        sums = collections.Counter()
        for (shape, k), n in counts.items():
            b, h, w, c = (batch,) + shape[1:]
            x = torch.randn((b, h, w, c), device="cuda", generator=gen).to(
                torch.bfloat16)
            wt = (0.2 * torch.randn((c, 1, k, k), device="cuda",
                                    generator=gen)).to(torch.bfloat16)
            packed = DC.pack_weight(wt)
            want = D.depthwise_plain(x.permute(0, 3, 1, 2), wt).permute(
                0, 2, 3, 1)
            y = torch.empty_like(x)
            auto = DC.launch_geometry(b, h, w, c, k, 2, True)
            row, auto_ms = [], None
            for rows, threads, cols in CHOICES:
                g = DC.launch_geometry(b, h, w, c, k, 2, True, rows=rows,
                                       threads=threads, cols=cols)
                y.zero_()
                DC.launch(x, packed, y, g)
                if not torch.equal(y, want):
                    raise AssertionError(f"{(b, h, w, c)} K={k} rows {rows} "
                                         f"threads {threads} cols {cols}: "
                                         f"differs")
                ms = cuda_ms(lambda: DC.launch(x, packed, y, g))
                label = f"r{rows} t{threads} c{cols}"
                sums[label] += n * ms
                row.append(f"{label}{'*' if g == auto else ''} {ms:.4f}")
                if g == auto and auto_ms is None:
                    auto_ms = ms
                    sums["default"] += n * ms
            lib = cuda_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), wt,
                                           padding=k // 2, groups=c))
            # Yardsticks of the memory path: a copy of x into y (the bound's
            # bytes) and the kernel at K = 1 (no reuse, one pass).
            copy = cuda_ms(lambda: y.copy_(x))
            one = DC.pack_weight(wt[:, :, 1:2, 1:2] if k > 1 else wt)
            k1 = cuda_ms(lambda: DC.launch(
                x, one, y, DC.launch_geometry(b, h, w, c, 1, 2, True)))
            bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
            for key, ms in (("cudnn", lib), ("copy", copy), ("K=1", k1),
                            ("bound", bound)):
                sums[key] += n * ms
            print(f"{name} {b}x{h}x{w}x{c} K={k} x{n}: " + ", ".join(row)
                  + f" ms; cuDNN {lib:.4f} ms, copy {copy:.4f} ms, K=1 "
                  f"{k1:.4f} ms, bytes bound {bound:.4f} ms", flush=True)
            del x, y, want
        print(f"{name} per forward at batch {batch} on {smi}: "
              + ", ".join(f"{key} {ms:.4f} ms" for key, ms in sums.items()),
              flush=True)
    sampler.terminate()
    sampler.wait()
    smi_log.close()
    with open(os.path.join(REPO, "build", "smi.csv")) as f:
        rows = [[float(v) for v in line.split(",")] for line in f
                if line.strip()]
    busy = [r for r in rows if r[2] > 150.0]
    if busy:
        for i, label in enumerate(("SM clock MHz", "memory clock MHz",
                                   "power W")):
            vals = sorted(r[i] for r in busy)
            print(f"while busy ({len(busy)} samples): {label} min "
                  f"{vals[0]}, median {vals[len(vals) // 2]}, max "
                  f"{vals[-1]}")
    return 0


def sass_histogram(lib):
    """``[(instance, instructions, [(opcode, count), ...]), ...]``: the
    static SASS of each depthwise kernel instance in ``lib``, by opcode
    (``cuobjdump -sass``)."""
    import re

    sass = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
        capture_output=True, text=True, check=True, timeout=300).stdout
    out, name, ops = [], None, None
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out.append((name, sum(ops.values()), ops.most_common()))
            k = re.search(r"depthwise_(tiled|scalar)I(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)+)", m.group(1))
            name = (f"{k.group(1)}<{'f32' if k.group(2) == 'f' else 'bf16'}"
                    f", {','.join(re.findall(r'Li(\d+)E', k.group(3)))}>"
                    if k else None)
            ops = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            ops[m.group(1).split(".")[0]] += 1
    return [o for o in out if "bf16" in o[0]]


if __name__ == "__main__":
    sys.exit(main())
