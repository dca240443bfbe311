"""Tracing and step timing (port of the JAX package's
``utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  (host operators and, on a GPU, its kernels) of a code region.
* :func:`run_maybe_traced` — the CLIs' shared ``--profile`` wrapper: the
  trace lands under ``<PATHS.LOGS>/profiles``.
* :func:`annotate` — a named region in that trace
  (``torch.profiler.record_function``); ``Predictor.forward`` and the
  Grad-CAM pass name their stages with it (``predict.preprocess``,
  ``predict.model``, ``gradcam.preprocess`` / ``forward`` / ``gradient`` /
  ``heatmap``).
* :class:`StepTimer` — wall-clock step timing with warm-up discard and
  percentile summaries (``benchmark.clock_avg_runtime``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "results/logs/profiles"):
    """Profile the region with ``torch.profiler`` (CPU activity, and CUDA
    activity when a GPU is present) and write it as a Chrome trace
    ``trace_<timestamp>.json`` in ``log_dir``; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, datetime.datetime.now().strftime(
        "trace_%Y%m%d-%H%M%S.json"))
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def run_maybe_traced(run, profile: bool, cfg) -> None:
    """Shared ``--profile`` wrapper of the CLI entry points: with
    ``profile``, trace ``run()`` into ``<PATHS.LOGS>/profiles`` and print
    where the trace landed; otherwise just run."""
    if not profile:
        run()
        return
    with trace(os.path.join(cfg["PATHS"]["LOGS"], "profiles")) as path:
        run()
    print(f"profiler trace written to {path}")


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with warm-up discard. Time steps on a GPU
    only where each ends in a synchronisation (the host clock otherwise
    sees the enqueue)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._times.append(time.perf_counter() - self._t0)

    @property
    def times(self) -> np.ndarray:
        # Warm-up samples are always discarded: a short run must not
        # report its first, slow steps as steady-state time.
        return np.asarray(self._times[self.warmup:])

    def summary(self) -> Dict[str, float]:
        t = self.times
        if not len(t):
            return {}
        return {
            "mean_ms": float(t.mean() * 1000),
            "std_ms": float(t.std() * 1000),
            "p50_ms": float(np.percentile(t, 50) * 1000),
            "p95_ms": float(np.percentile(t, 95) * 1000),
            "steps": int(len(t)),
        }
