#!/usr/bin/env python3
"""Launch-plan sweep of the PyTorch port's preprocess kernel (B1,
``ab_line_classifier_torch/csrc/preprocess.cu``) on one NVIDIA GPU.

At every shape the port's paths give the kernel (``chip_smoke.B1_SHAPES``)
it launches the kernel under the plan's own choice (marked ``*``), on each
of its paths (``launch_plan(..., path=...)``: staged, gathered, the scalar
branch), and under other values of the module's constants that set rows
per stage, stages in the ring and waves of blocks (``GROUP``, ``STAGES``,
``WAVES``, which this script sets in turn). Each is held bit-equal to
the plain version and timed as chip_smoke times it (a CUDA graph of its
launches, per launch), beside the bytes bound. It prints ptxas's
registers and spills of each kernel instance. Run from the root of a checkout::

    python3 scripts/torch_preprocess_tune.py [--split]

With ``--split`` it times instead, at the plan's own choice, the kernel
and three builds of its source that each leave one part of the work out
(the arithmetic, the source copies, the output stores; their outputs are
wrong), which shows what bounds it.
"""

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Builds for --split: the source with one part of the work left out, by
# [(text of the source, its replacement), ...].
SPLIT = {
    "no arithmetic": [
        ("      if (masked)\n        unit<", "      if (false)\n        unit<"),
        ("      else\n        unit<", "      else if (false)\n        unit<")],
    "no source copies": [
        ("bytes = static_cast<uint32_t>(a1 - a0);", "bytes = 0;")],
    "no output stores": [
        ("        bulk_store(out", "        if (false) bulk_store(out")],
}


def split_libraries(S, _build, PC):
    """{name: typed library} of the kernel and of each SPLIT build."""
    import ctypes

    src = os.path.join(_build.CSRC_DIR, "preprocess.cu")
    with open(src) as f:
        text = f.read()
    libs = {"kernel": PC.KERNEL.typed(
        ctypes.CDLL(_build.build("preprocess")))}
    for name, edits in SPLIT.items():
        variant = text
        for old, new in edits:
            if old not in variant:
                raise RuntimeError(f"--split: the source has no {old!r}")
            variant = variant.replace(old, new)
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        path = os.path.join(_build.BUILD_DIR,
                            f"preprocess-{name.replace(' ', '-')}.cu")
        with open(path, "w") as f:
            f.write(variant)
        lib = _build._hashed_path(path, _build.NVCC_FLAGS, _build.BUILD_DIR,
                                  f"preprocess-{name.replace(' ', '-')}")
        _build._compile([_build._nvcc(), *_build.NVCC_FLAGS, path], lib,
                        f"preprocess {name}")
        libs[name] = PC.KERNEL.typed(ctypes.CDLL(lib))
    return libs


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    split = sys.argv[1:] == ["--split"]
    sys.path.insert(0, REPO)
    import chip_smoke as S
    from ab_line_classifier_torch.ops import _build
    from ab_line_classifier_torch.ops import preprocess_cuda as PC
    from ab_line_classifier_torch.ops.image import fused_preprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = _build.build("preprocess")
    for name, line in S.ptxas_report(_build.build_log("preprocess")):
        print(f"ptxas {name}: {line}")
    # The instances' SASS, for reading their inner loops.
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                          capture_output=True, text=True, timeout=300).stdout
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "preprocess.sass"), "w") as f:
        f.write(sass)

    if split:
        libs = split_libraries(S, _build, PC)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, src_hw, resize, dtype, blank, inputs, per_graph in \
            S.B1_SHAPES:
        xs = [torch.randint(0, 256, (b, *src_hw, 3), dtype=torch.uint8,
                            device="cuda", generator=gen)
              for _ in range(inputs)]
        kw = dict(out_hw=S.OUT_HW, preprocess_mode="caffe",
                  resize_mode=resize, out_dtype=dtype, blank_ui_region=blank)
        want = fused_preprocess(xs[0], **kw)
        outs = [torch.empty_like(want) for _ in range(per_graph)]
        itemsize = 2 if dtype == torch.bfloat16 else 4
        bound = S.preprocess_bytes(b, src_hw, S.OUT_HW, resize, itemsize,
                                   False, blank=blank) / S.HBM_BYTES_PER_S \
            * 1e3
        base = PC.launch_plan(src_hw, S.OUT_HW, resize, batch=b,
                              out_dtype=dtype, blank_ui_region=blank)
        if split:
            _, args = PC.plan_launch(b, src_hw, S.OUT_HW, resize, "caffe",
                                     dtype, blank, xs[0].device)
            times = []
            for name, lib in libs.items():
                PC.KERNEL.lib = lib

                def run():
                    for i in range(per_graph):
                        PC.launch(xs[i % inputs], outs[i], args)

                times.append(f"{name} {S.graph_ms(run) / per_graph:.4f}")
            PC.KERNEL.lib = libs["kernel"]
            print(f"{label} ({smi}), ms: " + ", ".join(times)
                  + f"; bytes bound {bound:.4f}", flush=True)
            continue
        knobs = (PC.GROUP, PC.STAGES, PC.WAVES)
        cases = [("*", None, knobs)] + [(path, path, knobs)
                                        for path in PC.PATHS]
        if base.group > 1:
            cases += [(f"group {g} stages {st} waves {w}", None, (g, st, w))
                      for g in (1, 2, 4) for st in (2, 3)
                      for w in (8, 16)]
        print(f"-- {label} ({smi}); bytes bound {bound:.4f} ms", flush=True)
        for name, path, (group, stages, waves) in cases:
            PC.GROUP, PC.STAGES, PC.WAVES = group, stages, waves
            try:
                plan, args = PC.plan_launch(
                    b, src_hw, S.OUT_HW, resize, "caffe", dtype, blank,
                    xs[0].device, path=path)
            except RuntimeError as e:
                print(f"{name}: {e}")
                continue
            PC.launch(xs[0], outs[0], args)
            equal = torch.equal(outs[0], want)

            def run():
                for i in range(per_graph):
                    PC.launch(xs[i % inputs], outs[i], args)

            ms = S.graph_ms(run) / per_graph
            print(f"{name:34s} staged={int(plan.staged)} vec={int(plan.vec)}"
                  f" group={plan.group} stages={plan.stages} threads="
                  f"{plan.threads} smem="
                  f"{plan.smem} fit={plan.blocks_per_sm} grid={plan.grid} "
                  f"px={plan.pixels}: {ms:.4f} ms "
                  f"({100 * bound / ms:.1f}%){'' if equal else ' UNEQUAL'}",
                  flush=True)
        PC.GROUP, PC.STAGES, PC.WAVES = knobs
        del xs, outs, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
