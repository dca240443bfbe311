"""A ``torch.profiler`` trace (CPU and CUDA activity) of a steady
sub-window, reduced to device busy time, idle gaps and kernel time by name.

The sub-window is the host interval of the ``bench.window`` annotation,
which the driver opens after a synchronize and closes after another, so
every device operation of its work lies inside it. Device operations are
the trace's kernels, memcpys and memsets; busy time is the length of the
union of their intervals within the sub-window."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterator, List, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclasses.dataclass
class Reduction:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]  # (name, start s, seconds)
    host: List[Tuple[str, float, float]]

    def kernel_time(self, *patterns: str) -> Tuple[int, float]:
        """Count and seconds of device operations whose name contains one
        of ``patterns``."""
        hits = [d for n, _, d in self.ops if any(p in n for p in patterns)]
        return len(hits), sum(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for n, _, d in self.ops:
            by[n] = by.get(n, 0.0) + d
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps between device operations (and at the
        sub-window's ends), each named by the innermost host event that
        covers its start."""
        gaps, end = [], 0.0
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s - end))
            end = max(end, s + d)
        if self.window_s > end:
            gaps.append((end, self.window_s - end))
        out = []
        for start, length in sorted(gaps, key=lambda g: -g[1])[:k]:
            covering = [(d, n) for n, s, d in self.host
                        if s <= start <= s + d and n != WINDOW]
            what = min(covering)[1] if covering else "host outside events"
            out.append([f"host in {what}", length])
        return out


def reduce(trace: dict) -> Reduction:
    """The chrome-trace JSON of one recording -> its sub-window's
    reduction (times in seconds from the sub-window's start)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    ops, host = [], []
    for e in events:
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = max(s, w0), min(s + d, w1)
        if hi <= lo and not (d == 0.0 and w0 <= s <= w1):
            continue
        item = (e.get("name", ""), (lo - w0) * 1e-6, (hi - lo) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            ops.append(item)
        elif e.get("cat") in HOST_CATS:
            host.append(item)
    busy, end = 0.0, 0.0
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    return Reduction((w1 - w0) * 1e-6, busy, ops, host)


@contextlib.contextmanager
def recording(device) -> Iterator[Dict]:
    """Profile the block; ``result["reduction"]`` is set on exit. The
    caller opens :func:`window` around the work inside, between two
    synchronizes. The trace file goes to ``TMPDIR`` and is removed."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    result: Dict = {}
    with profile(activities=acts) as prof:
        yield result
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            result["reduction"] = reduce(json.load(f))
    finally:
        os.remove(path)


def window():
    return torch.profiler.record_function(WINDOW)
