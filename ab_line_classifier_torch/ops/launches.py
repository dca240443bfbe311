"""The kernels' launch counts, under CUDA graphs too.

The shared launch path (``ops/_build.py::Kernel.launch``) adds one to its
kernel's count (:data:`KERNELS`) where a launch succeeds. A CUDA graph's
capture calls the wrappers but launches nothing, and a replay launches the
captured kernels without calling them. Every graph of the port (the
graphed training epochs, ``train/graphed.py``; the Grad-CAM pass and the
serving forward, one graph per input shape, ``explain/gradcam.py`` and
``predict/predict.py``; the auto-masking chain, one graph per sampled-clip
shape, ``data/auto_masking.py``; the batch-1 latency chain,
``predict/benchmark.py``; the attribution's segments,
``predict/attribution.py``) is captured inside :func:`capture`, which takes
the capture's calls off the counts and keeps them, and each replay calls
:meth:`CapturedLaunches.replayed`, which adds them back. So a count is
always the launches that ran on the card, eagerly or in a replay.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, Iterator

#: The kernels, by the key their launches are counted under: B1, B2, the
#: conv epilogue and the batch norm pass.
KERNELS = ("preprocess", "depthwise", "epilogue", "bn_act")

_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def add(kernel: str, n: int = 1) -> None:
    """Count ``n`` launches of ``kernel``."""
    _counts[kernel] += n


def count(kernel: str) -> int:
    """Launches of ``kernel`` since the last :func:`reset`."""
    return _counts[kernel]


def counts() -> Dict[str, int]:
    """Each kernel's launches since the last :func:`reset`, by kernel."""
    return dict(_counts)


def reset() -> None:
    """Zero every kernel's count."""
    for kernel in KERNELS:
        _counts[kernel] = 0


class CapturedLaunches:
    """The kernel launches one CUDA graph makes each replay."""

    def __init__(self):
        #: Launches a replay makes, by kernel (set when the capture ends).
        self.per_replay: Dict[str, int] = {}

    def replayed(self, n: int = 1) -> None:
        """Count ``n`` replays of the graph."""
        for kernel, per in self.per_replay.items():
            add(kernel, n * per)


@contextlib.contextmanager
def capture() -> Iterator[CapturedLaunches]:
    """Around a CUDA graph's capture: the wrapper calls made inside are
    kept as the graph's launches per replay and taken off the counts.

    Python's cyclic collector is paused inside: a dead object cycle can
    hold another CUDA graph (a trainer's programs close over the trainer),
    and a collection during the capture would destroy that graph and its
    memory pool mid-capture, which invalidates the capture."""
    record = CapturedLaunches()
    before = counts()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield record
    finally:
        if collecting:
            gc.enable()
        for kernel in KERNELS:
            record.per_replay[kernel] = _counts[kernel] - before[kernel]
            _counts[kernel] = before[kernel]
