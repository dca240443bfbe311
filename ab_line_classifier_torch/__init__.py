"""ab_line_classifier_torch — the PyTorch/CUDA port of the lung-ultrasound
A-line vs B-line classifier, for one NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package beside it (``*_tpu``) is the reference every
module here is held against; module names mirror it so each counterpart is
easy to find. This package imports ``torch`` and never JAX, and nothing of
the JAX package: it keeps its own copies of what it needs.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises
(:func:`resolve_device`). On CUDA, preprocessing runs the hand-written
kernel in ``csrc/preprocess.cu`` and every stride-1 ``SAME`` depthwise
layer the one in ``csrc/depthwise.cu``; on the CPU each runs its kernel's
plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``. Asking for CUDA on a host without it raises — nothing falls
    back to the CPU unless the caller asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu on the CLI) to run on the CPU")
    return dev
