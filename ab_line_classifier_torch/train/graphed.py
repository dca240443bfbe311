"""CUDA-graph epochs: the port's counterpart of the JAX package's one-program
epochs (``Trainer.make_epoch_fns`` and ``_run_epoch``, ``train/loop.py``;
``ParallelFoldTrainer.make_epoch_fns``, ``parallel/trial_parallel.py``),
which scan the train or eval step over an epoch's index table.

An epoch over a device cache is a ``[nb, ...]`` table of row indices and
validity masks (:class:`EpochTables`), uploaded once per epoch. A step
reads its row at a device cursor, gathers its batch on the device, runs
and advances the cursor: the scan's body, with the cursor as its carry.
:class:`StepGraph` runs that step:

* on CUDA the first call runs eagerly on a side stream (a real step of
  the epoch, which also makes what is made lazily: the optimizer's state,
  the libraries' handles and workspaces, the kernels' index tables, a
  process group's communicator); the next call captures the step as a
  CUDA graph, which launches nothing, and replays it for its own batch,
  as every later call does;
* on the CPU, and where a collective of the step runs under gloo (gloo's
  collectives cannot be captured), every call runs the step itself: the
  code the card replays, so the CPU tests hold it.

A capture that fails raises; nothing reruns the step eagerly. The
Grad-CAM pass (``explain/gradcam.py``), the serving forward
(``predict/predict.py``, in inference mode) and the auto-masking chain
(``data/auto_masking.py``, in inference mode and IEEE float32) run
through :class:`StepGraph` too, one per input shape.

What a step may do, to be captured: device work only, on tensors whose
addresses stay put. Host values it needs change between replays through
device tensors: the learning rate, the step counts and Adam's bias
correction (``models/common.py``); the generators' seeds (the generators
are registered with the graph and re-seeded before each replay); the
trial-parallel trainer's augmentation and dropout, drawn on the host and
copied into fixed buffers. State a layer replaces is put back in place
(``graph.buffers_in_place``), and the depthwise layers' packed weights
are packed inside the graph (``graph.drop_packed_weights`` before and
after a capture).

Launch counts: a capture's kernel-wrapper calls are taken off the counts
and each replay adds them back (``ops/launches.py``), so the counts are
the launches that ran on the card; :attr:`StepGraph.captured_launches`
keeps a replay's.

Spans: each call of a :class:`StepGraph` is one profiler region named by
what it did and the program's kind (``name``): ``graph.eager:<name>``,
``graph.capture:<name>`` or ``graph.replay:<name>`` on CUDA,
``graph.run:<name>`` uncaptured (``utils/profiling.annotate``; free when
no profiler records). A replay's region holds its ``cudaGraphLaunch``, so
the device work it enqueues is placed on the host's timeline.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.ops import launches
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.utils.profiling import annotate


# One side stream per device for every eager warm-up step: a library that
# keeps a workspace per stream (cuBLAS) makes one, not one per graph.
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capturable(device: torch.device, groups: Sequence = ()) -> bool:
    """Whether a step on ``device`` whose collectives run over ``groups``
    can be captured: a CUDA device, and every group none or NCCL."""
    return (torch.device(device).type == "cuda"
            and all(mesh_lib.graph_capturable(g) for g in groups))


class EpochTables:
    """An epoch's row-index and validity-mask tables (``[nb, ...]``) on the
    device, and the cursor of the step at work. :meth:`load` puts a new
    epoch into the same tensors; :meth:`row` reads the cursor's row on the
    device and :meth:`advance` moves the cursor there, so a step reads
    each replay's own batch."""

    def __init__(self, shape: Sequence[int], device):
        self.idx = torch.zeros(tuple(shape), dtype=torch.int64,
                               device=device)
        self.mask = torch.zeros(tuple(shape), dtype=torch.float32,
                                device=device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=device)

    @property
    def n_steps(self) -> int:
        return self.idx.shape[0]

    @torch.no_grad()
    def load(self, idx, mask) -> None:
        """An epoch's tables (host arrays or tensors) and the cursor at 0."""
        self.idx.copy_(torch.as_tensor(idx))
        self.mask.copy_(torch.as_tensor(mask))
        self.cursor.zero_()

    def row(self):
        """The cursor's ``(indices, mask)`` row."""
        return (self.idx.index_select(0, self.cursor)[0],
                self.mask.index_select(0, self.cursor)[0])

    def advance(self) -> None:
        self.cursor += 1


class StepGraph:
    """One training or evaluation step, ``body`` (a callable of no
    arguments doing device work only), run as the module note says:
    captured and replayed when ``capture`` (a CUDA device whose
    collectives can be captured), else run each call. ``name`` is the
    program's kind (``serve``, ``train``, ...), which its spans carry
    (module note). ``generators`` are
    the CUDA generators the step draws from (registered with the graph;
    the caller seeds them before each call); ``modules`` the modules whose
    depthwise weights it packs; ``pool`` a memory pool
    (``torch.cuda.graph_pool_handle()``) the graph shares with others
    replayed one at a time on one stream (default: a private one)."""

    def __init__(self, body: Callable[[], None], device, *, name: str,
                 capture: bool, generators: Sequence[torch.Generator] = (),
                 modules: Sequence[torch.nn.Module] = (), pool=None):
        self.body = body
        self.name = name
        self._spans = {k: f"graph.{k}:{name}"
                       for k in ("eager", "capture", "replay", "run")}
        self.device = torch.device(device)
        self.capture = bool(capture)
        self.generators = tuple(generators)
        self.modules = tuple(modules)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.eager_steps = 0
        self.replays = 0
        self.capture_seconds: Optional[float] = None
        self._launches: Optional[launches.CapturedLaunches] = None

    @property
    def captured_launches(self) -> Optional[Dict[str, int]]:
        """Kernel launches one replay makes, by kernel (None before the
        capture)."""
        return None if self._launches is None else self._launches.per_replay

    @property
    def mode(self) -> str:
        """``graphed`` or ``uncaptured``."""
        return "graphed" if self.capture else "uncaptured"

    def __call__(self) -> None:
        if not self.capture:
            with annotate(self._spans["run"]):
                self.body()
            return
        if self.graph is None and self.eager_steps == 0:
            with annotate(self._spans["eager"]):
                self._eager()
            return
        with annotate(self._spans["replay" if self.graph is not None
                                  else "capture"]):
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            self._launches.replayed()

    def _eager(self) -> None:
        """The step on a side stream (the order a capture's warm-up
        needs), ordered after and before the current stream's work."""
        side = _SIDE_STREAMS.get(self.device)
        if side is None:
            side = _SIDE_STREAMS[self.device] = torch.cuda.Stream(
                self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body()
        current.wait_stream(side)
        self.eager_steps += 1

    def _capture(self) -> None:
        t0 = time.perf_counter()
        for m in self.modules:
            G.drop_packed_weights(m)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with launches.capture() as self._launches, torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            self.body()
        for m in self.modules:
            G.drop_packed_weights(m)
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0

    def end_epoch(self) -> None:
        """After an epoch's replays: the packed weights a replay left in
        the graph's memory are forgotten, so an eager forward packs the
        weights anew."""
        if self.graph is not None:
            for m in self.modules:
                G.drop_packed_weights(m)

    def summary(self) -> Dict:
        """What ran: the program's kind, the mode, the eager steps, the
        replays, the capture's seconds and the kernel launches a replay
        makes."""
        return {"name": self.name, "mode": self.mode,
                "eager_steps": self.eager_steps,
                "replays": self.replays,
                "capture_seconds": self.capture_seconds,
                "captured_launches": self.captured_launches}


def step_seeds(seed: int, phase_idx: int, step: int, *lead: int
               ) -> np.ndarray:
    """The two generator seeds (augmentation, dropout) of one step, from
    ``(seed, phase_idx, step, *lead)``."""
    return np.random.SeedSequence(
        [seed, phase_idx, step, *lead]).generate_state(2, np.uint64)
