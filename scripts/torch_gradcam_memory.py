#!/usr/bin/env python3
"""Peak device memory of one eager Grad-CAM pass of the PyTorch port on one
NVIDIA GPU: each served model (cutoffvgg16, mobilenetv2, xception,
efficientnetb7, full width, 128x128, random weights from a seed), in
bfloat16 and float32, at batch 256, ``normal`` mode. A CUDA graph of the
pass (``explain/gradcam.py::FusedGradCAM``) keeps this much in its memory
pool for as long as the pass lives.

Each ROOT is a directory holding an ``ab_line_classifier_torch`` package
(default: this checkout); each is measured in a process of its own, so a
``git archive`` of another commit unpacked into a directory compares with
this one. Run from the root of a checkout::

    python3 scripts/torch_gradcam_memory.py [ROOT ...]
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("cutoffvgg16", "mobilenetv2", "xception", "efficientnetb7")
BATCH = 256


def measure(root: str) -> None:
    """Print the eager pass's peak of each model and dtype, the port
    imported from ``root``."""
    sys.path.insert(0, root)
    import torch

    from ab_line_classifier_torch.explain.gradcam import build_fused_gradcam
    from ab_line_classifier_torch.ops import _build
    from ab_line_classifier_torch.predict.benchmark import (build_zoo,
                                                            seeded_state)
    from ab_line_classifier_torch.predict.predict import load_module

    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(_build.build, _build.kernel_names()))
    frames = torch.randint(0, 256, (BATCH, 128, 128, 3), dtype=torch.uint8,
                           device="cuda")
    for name in MODELS:
        spec = build_zoo(name)
        state = seeded_state(spec, 0)
        for dtype in (torch.bfloat16, torch.float32):
            spec_d = dataclasses.replace(spec, dtype=dtype)
            fused = build_fused_gradcam(
                spec_d, load_module(spec_d, state, torch.device("cuda")))
            run = getattr(fused, "eager", fused)
            run(frames)             # workspaces and index tables made
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run(frames)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
            print(f"{root}: {name} {str(dtype).split('.')[-1]} batch {BATCH}"
                  f": eager Grad-CAM pass peak {peak:.3f} GiB", flush=True)
            del fused, run
            torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        measure(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:] or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        os.path.abspath(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
