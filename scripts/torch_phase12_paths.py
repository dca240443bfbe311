#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` (the PyTorch port's serial
cross-validation and Bayesian sweep over a device cache, full width) run
with its cached epochs graphed and per step, alternately, in one process
on one NVIDIA GPU.

Each pass calls ``chip_smoke.phase_experiments`` unchanged, with
``Trainer.run_epoch`` either the port's own (a device cache's epoch as a
CUDA graph of the step, ``train/graphed.py``) or replaced by
``Trainer.run_epoch_per_step`` (every step dispatched from the host, as
before the graphed epochs). Passes run per step, graphed, graphed, per
step, then, after a 60 GiB allocation is freed into the caching
allocator's cache, graphed and per step again. Each fold and trial prints
its wall, training frames/s, the path its epochs took, its captures'
seconds and the allocator's retries; each pass prints its seconds. Run
from the root of a checkout::

    python3 scripts/torch_phase12_paths.py
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ab_line_classifier_torch.ops import _build  # noqa: E402
from ab_line_classifier_torch.train.loop import Trainer  # noqa: E402

PASSES = ("per-step", "graphed", "graphed", "per-step", "fill", "graphed",
          "per-step")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase12_paths: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in _build.kernel_names():
        _build.build(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    graphed = Trainer.run_epoch
    check_runs = chip_smoke.check_runs

    def per_step(self, dataset, batch_size, *, train, shuffle_seed=0):
        return self.run_epoch_per_step(dataset, batch_size, train=train,
                                       shuffle_seed=shuffle_seed)

    def any_path(*args, path=None, **kw):
        return check_runs(*args, **kw)

    chip_smoke.check_runs = any_path
    for label in PASSES:
        if label == "fill":
            x = torch.empty(60 * 2 ** 30, dtype=torch.uint8, device="cuda")
            del x
            print(f"=== cache filled: reserved "
                  f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB",
                  flush=True)
            continue
        Trainer.run_epoch = per_step if label == "per-step" else graphed
        t0 = time.perf_counter()
        print(f"=== phase 12 {label}", flush=True)
        chip_smoke.phase_experiments(smi)
        torch.cuda.synchronize()
        print(f"=== phase 12 {label}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
