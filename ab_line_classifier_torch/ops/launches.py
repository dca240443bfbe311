"""The kernels' launch counts under CUDA graphs.

Each kernel wrapper (``preprocess_cuda``, ``depthwise_cuda``,
``conv_epilogue_cuda``, ``bn_act_cuda``) adds one to
its ``launch_count`` where it launches its kernel. A CUDA graph's capture
calls the wrappers but launches nothing, and a replay launches the
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

from ab_line_classifier_torch.ops import (bn_act_cuda, conv_epilogue_cuda,
                                          depthwise_cuda, preprocess_cuda)

_COUNTERS = {"preprocess": preprocess_cuda, "depthwise": depthwise_cuda,
             "epilogue": conv_epilogue_cuda, "bn_act": bn_act_cuda}


def counts() -> Dict[str, int]:
    """Each kernel's ``launch_count``, by kernel name."""
    return {name: mod.launch_count for name, mod in _COUNTERS.items()}


class CapturedLaunches:
    """The kernel launches one CUDA graph makes each replay."""

    def __init__(self):
        #: Launches a replay makes, by kernel (set when the capture ends).
        self.per_replay: Dict[str, int] = {}

    def replayed(self, n: int = 1) -> None:
        """Count ``n`` replays of the graph."""
        for name, mod in _COUNTERS.items():
            mod.launch_count += n * self.per_replay[name]


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
        for name, mod in _COUNTERS.items():
            record.per_replay[name] = mod.launch_count - before[name]
            mod.launch_count = before[name]
