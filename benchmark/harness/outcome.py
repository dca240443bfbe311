"""What a driver hands back to ``run.py``, and the device helpers the
drivers share."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import torch

from harness import work as W
from harness.trace import Reduction


@dataclasses.dataclass
class View:
    """What the per-layer metric readers read (``benchmark/metrics``):
    the traffic's kind, the traced sub-window's reduction and the work it
    held, and the cell's work counts."""
    kind: str
    trace: Optional[Reduction] = None
    frames: int = 0          # frames served, or trained, in the sub-window
    val_frames: int = 0      # frames validated in the sub-window (fit)
    work: Dict = dataclasses.field(default_factory=dict)
    peaks: Dict = dataclasses.field(default_factory=lambda: dict(W.PEAKS))


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    view: View
    memory_peak_bytes: int
    notes: List[str] = dataclasses.field(default_factory=list)


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if is_cuda(device) else 0


def release(device) -> None:
    """After the program's state is dropped: its memory back."""
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def launch_note(before: Dict[str, int], after: Dict[str, int],
                red: Reduction, metrics) -> List[str]:
    """The kernels the trace recorded against the launches the program
    counted in the sub-window (``ops/launches.py``), where they differ, for
    each kernel a per-layer metric of ``metrics`` reads."""
    notes = []
    for key, names in dict(m.launches for m in metrics if m.launches
                           ).items():
        counted = after.get(key, 0) - before.get(key, 0)
        recorded = red.kernel_time(*names)[0]
        if counted != recorded:
            notes.append(f"trace: {recorded} {key} kernels recorded, "
                         f"{counted} launched in the traced sub-window")
    return notes


def set_up(marks) -> str:
    """A line of set-up's stages: each ends at the seconds given."""
    return "set-up: " + ", ".join(f"{name} {t:.3f} s" for name, t in marks)
