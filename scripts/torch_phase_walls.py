#!/usr/bin/env python3
"""Wall seconds of phases 12 and 13 of ``chip_smoke.py`` (the PyTorch
port's serial and trial-parallel cross-validation and sweeps, full width)
of the checkout at ROOT, on one NVIDIA GPU.

The phases run unchanged (``chip_smoke.phase_experiments`` and
``phase_trial_parallel``) after the kernels of ROOT are built; the last
line gives each phase's seconds and the card. To compare two checkouts on
one card, run them alternately in one call, e.g. a parent unpacked into
an ignored directory and this checkout::

    python3 scripts/torch_phase_walls.py build/base parent
    python3 scripts/torch_phase_walls.py . change
    python3 scripts/torch_phase_walls.py . change
    python3 scripts/torch_phase_walls.py build/base parent
"""

import concurrent.futures
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_phase_walls: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import chip_smoke
    from ab_line_classifier_torch.ops import _build

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(_build.build, _build.kernel_names()))
    t0 = time.perf_counter()
    _, serial = chip_smoke.phase_experiments(smi)
    t1 = time.perf_counter()
    chip_smoke.phase_trial_parallel(smi, serial)
    t2 = time.perf_counter()
    print(f"{label}: phase 12 {t1 - t0:.2f} s, phase 13 {t2 - t1:.2f} s "
          f"on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
