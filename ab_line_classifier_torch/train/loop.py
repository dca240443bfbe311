"""The training loop (port of the JAX package's ``train/loop.py``): the
train and eval steps, the phase plan, Keras's callbacks and resume.

Semantics kept from the JAX package:

* weighted categorical cross-entropy, activity regularizers, masked
  partial batches (``train/objective.py``);
* streamed accuracy, binned AUC and per-class precision / recall
  (``ops/metrics.py``), summed on the device inside the step;
* EarlyStopping(val_loss, PATIENCE, restore_best_weights) and
  ReduceLROnPlateau(x0.5, PATIENCE // 2, min_delta 1e-4, min_lr 1e-8)
  (:class:`CallbackState`); the best weights come back only when early
  stopping triggers;
* each phase gets a fresh optimizer, trainability and callback state, as
  Keras's separate ``fit`` calls; the weights carry over;
* the randomness of a step (augmentation, dropout) is a function of
  ``(seed, phase index, step)`` (:func:`step_generators`), so phases do not
  replay one another's draws and a resumed run draws what the
  uninterrupted one would;
* with ``checkpoint_dir`` the whole state is saved every epoch, atomically
  (``utils/resume.py``), and ``resume`` continues from it.

A training step is one augmentation -> forward -> loss -> backward ->
optimizer update, on the trainer's device; the parameters stay float32 and
a mixed-precision model computes in bfloat16 inside each layer
(``graph.set_compute_dtype``).

Epochs follow the JAX package's split (``_run_epoch``): the JAX package
runs an epoch over a device cache as one compiled program
(``make_epoch_fns``: a ``lax.scan`` of the step over the epoch's index
table), which takes the per-step dispatch off the host; a streamed
dataset goes step by step. Here an epoch over a ``DeviceCachedDataset``
(or its sharded form) is a graphed epoch (``train/graphed.py``): the
index and mask tables go over once, each step gathers its batch on the
device from its row, and the step, captured once a phase as a CUDA graph
(and once for evaluation), is replayed for every batch, the two
generators re-seeded from ``(seed, phase index, step)`` before each
replay, so a replay draws what the step would draw eagerly. On the CPU,
and where a collective of the step runs under gloo, the same step runs
uncaptured. A streamed ``FrameDataset`` (or ``FrameArrays``) goes a batch
at a time from the host, batch k+1's copy issued through pinned buffers
before step k, each batch copied into the fixed inputs of the program of
its shape (train or eval): the JAX package's jitted per-batch steps
(``make_train_step``, ``make_eval_step``). That program is a
:class:`StepGraph` too, captured once a phase (and once for evaluation)
and replayed a batch, the generators re-seeded before each call
(:meth:`Trainer.run_epoch_streamed`, :meth:`Trainer.streamed_step`).
:meth:`Trainer.run_epoch_per_step` is the same epoch dispatched op by op
(``train_step``, ``eval_step``): the reference the graphs are held to.
:attr:`Trainer.epoch_mode` says which path the last epoch took.

With a ``mesh`` (``parallel/mesh.py``) the step is data-parallel over its
``data`` axis, one process per device: the state is built from the same
seed and broadcast from rank 0; each rank takes its rows of every batch
(``batches(rows=)``) and draws the augmentation and dropout of the global
batch, keeping its rows; batch norms take the global batch's statistics
(``graph.set_data_parallel``); the loss divides by the global batch's
valid count and the gradients are summed over the axis (one
``all_reduce`` a dtype), so every rank applies the same update; the
metrics are summed once an epoch (``ops.metrics.reduce_metrics``). The
callbacks' host logic then runs alike on every rank, and only rank 0
prints and writes the resume file.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.data.augment import affine_params_from_config
from ab_line_classifier_torch.data.pipeline import (
    DeviceCachedDataset, PinnedStaging, ShardedDeviceCachedDataset,
    drain_behind)
from ab_line_classifier_torch.models.common import (
    ModelSpec, TrainPhase, get_learning_rate, make_optimizer,
    scale_learning_rate)
from ab_line_classifier_torch.models.preprocess import get_preprocess_fn
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.train import objective
from ab_line_classifier_torch.train.graphed import (EpochTables, StepGraph,
                                                    capturable, step_seeds)
from ab_line_classifier_torch.utils.profiling import annotate
from ab_line_classifier_torch.utils.resume import load_resume, save_resume

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EpochLog:
    epoch: int
    phase: str
    train: Dict[str, float]
    val: Dict[str, float]
    lr: Optional[float]
    seconds: float


@dataclasses.dataclass
class CallbackState:
    """Keras EarlyStopping + ReduceLROnPlateau decisions as plain state:
    EarlyStopping(val_loss, patience, min_delta 0) and
    ReduceLROnPlateau(factor 0.5, patience // 2, min_delta 1e-4, min_lr
    1e-8), each tracking improvement on its own, as the Keras classes do."""

    patience: int
    plateau_patience: int
    factor: float = 0.5
    min_lr: float = 1e-8
    plateau_min_delta: float = 1e-4

    best_val: float = np.inf
    best_plateau: float = np.inf
    wait: int = 0
    plateau_wait: int = 0

    def update(self, monitored: float, lr: float):
        """One epoch's val_loss -> ``(improved, stop, new_lr or None)``."""
        improved = monitored < self.best_val
        if improved:
            self.best_val = monitored
            self.wait = 0
        else:
            self.wait += 1
        new_lr = None
        if monitored < self.best_plateau - self.plateau_min_delta:
            self.best_plateau = monitored
            self.plateau_wait = 0
        else:
            self.plateau_wait += 1
            if self.plateau_wait >= self.plateau_patience:
                reduced = max(lr * self.factor, self.min_lr)
                if reduced < lr:
                    new_lr = reduced
                self.plateau_wait = 0
        stop = self.wait >= self.patience
        return improved, stop, new_lr


def step_generators(seed: int, phase_idx: int, step: int,
                    device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """The augmentation and dropout generators of one training step, on
    ``device``, seeded from ``(seed, phase_idx, step)``."""
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in step_seeds(seed, phase_idx, step))


def _copy_state(module: torch.nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@dataclasses.dataclass
class _StreamedStep:
    """A streamed epoch's program: one kind (train or eval) at one batch
    shape, its fixed inputs (images, labels, mask), the global batch's
    valid count under a mesh (written before each call) and its step."""

    inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    denom: torch.Tensor
    step: StepGraph


@dataclasses.dataclass
class _CachedEpoch:
    """A graphed epoch's program: one kind (train or eval) over one device
    cache at one batch size, its tables, metrics and step."""

    dataset: DeviceCachedDataset
    batch_size: int
    tables: EpochTables
    metrics: M.MetricsState
    step: StepGraph


class Trainer:
    """Drives a :class:`ModelSpec` through its phase plan on one device
    (``cuda`` unless ``device`` says otherwise), data-parallel over the
    ``data`` axis of ``mesh`` when given (this rank's device).

    ``compute_dtype`` bfloat16 trains mixed precision (float32 parameters).
    ``seed`` seeds the fresh module and every step's generators.
    """

    RESUME_FILE = "train_state.pt"

    def __init__(self, spec: ModelSpec, *,
                 class_weight: Optional[Dict[int, float]] = None,
                 class_names: Optional[List[str]] = None,
                 aug_config: Optional[Dict] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
        self.shard = (mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS),
                      mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS))
        self.spec = spec
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.class_names = class_names or [str(i)
                                           for i in range(spec.n_classes)]
        self.preprocess_fn = get_preprocess_fn(spec.preprocess_mode)
        self.aug_params = (affine_params_from_config(aug_config)
                           if aug_config else None)
        w = np.ones((spec.n_classes,), np.float32)
        for i, v in (class_weight or {}).items():
            w[int(i)] = v
        self.class_weight = torch.as_tensor(w, device=self.device)
        self.reg_layers = tuple(spec.activity_regularizers)
        self.reg_lambdas = [spec.activity_regularizers[n]
                            for n in self.reg_layers]
        self.module = spec.logits_module(
            capture=self.reg_layers,
            generator=torch.Generator().manual_seed(self.seed)).to(
                self.device, memory_format=torch.channels_last)
        G.set_compute_dtype(self.module,
                            None if compute_dtype == torch.float32
                            else compute_dtype)
        G.set_data_parallel(self.module, self.data_group)
        if mesh is not None:
            mesh_lib.broadcast_tensors(
                list(self.module.state_dict().values()),
                mesh_lib.world_group())
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.phase_idx = 0
        self.step = 0
        #: The path of the last epoch: ``graphed`` (a device cache, the
        #: step captured and replayed), ``uncaptured`` (a device cache, the
        #: same step run each batch: the CPU, a gloo group),
        #: ``streamed-graphed`` / ``streamed-uncaptured`` (host batches
        #: through the program of their shape) or ``per-step`` (op by op,
        #: :meth:`run_epoch_per_step`).
        self.epoch_mode: Optional[str] = None
        #: The graphed epochs' programs, ``train`` (this phase's) and
        #: ``eval``; released at the end of :meth:`fit`.
        self.epoch_programs: Dict[str, _CachedEpoch] = {}
        #: The streamed steps' programs by ``(train, shapes and dtypes of
        #: images, labels, mask)``; the training ones this phase's;
        #: released at the end of :meth:`fit`.
        self.streamed_programs: Dict[tuple, _StreamedStep] = {}
        self._streamed_metrics: Dict[bool, M.MetricsState] = {}
        self._generators: Optional[Tuple[torch.Generator, ...]] = None

    # ------------------------------------------------------------------
    def begin_phase(self, phase_idx: int, phase: TrainPhase,
                    variables: Optional[StateDict] = None) -> None:
        """Start ``phase``: load ``variables`` (a state dict) when given,
        freeze its batch norms and layers, a fresh optimizer, step 0."""
        if variables is not None:
            self.module.load_state_dict(variables)
        self.module.set_inference_bn(self.spec.frozen_bn_layers(phase))
        self.optimizer = make_optimizer(phase, self.module)
        self.phase_idx = phase_idx
        self.step = 0
        # Trainability, frozen batch norms and the optimizer are the
        # phase's: its training step is captured anew.
        self.epoch_programs.pop("train", None)
        for key in [k for k in self.streamed_programs if k[0]]:
            del self.streamed_programs[key]

    @property
    def graph_mode(self) -> str:
        """``graphed`` or ``uncaptured``: the path a program's step takes
        (uncaptured on the CPU and under a gloo data group)."""
        return ("graphed" if capturable(self.device, [self.data_group])
                else "uncaptured")

    def release_programs(self) -> None:
        """Drop every program and its graph's memory."""
        self.epoch_programs.clear()
        self.streamed_programs.clear()

    def state(self) -> StateDict:
        """The module's state dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, metrics: M.MetricsState,
                   denom: Optional[float] = None) -> torch.Tensor:
        """One step on a uint8 ``[B, H, W, 3]`` batch on the device (labels
        ``[B]``, mask ``[B]``): augment, forward, loss, backward, update;
        accumulates ``metrics``. Returns the loss (on the device).

        Under a mesh the batch is this rank's rows of the global batch,
        ``denom`` the global batch's valid count (summed over the data
        group when not given), and the loss returned this rank's share of
        the global one."""
        gen_aug, gen_drop = step_generators(self.seed, self.phase_idx,
                                            self.step, self.device)
        loss = self._train_core(images, labels, mask, metrics, gen_aug,
                                gen_drop, denom)
        self.step += 1
        return loss

    def _train_core(self, images, labels, mask, metrics, gen_aug, gen_drop,
                    denom) -> torch.Tensor:
        """:meth:`train_step`'s device work, drawing from the given
        generators: no host value, so a graphed epoch captures it. The
        batch norms' running statistics stay in their tensors
        (``graph.buffers_in_place``), where a captured step reads them."""
        self.module.train()
        labels_oh = M.one_hot(labels, self.spec.n_classes)
        x = objective.prepare_images(self.preprocess_fn, self.aug_params,
                                     self.compute_dtype, images, gen_aug,
                                     shard=self.shard)
        if denom is None and self.data_group is not None:
            total = mask.to(torch.float32).sum().reshape(1)
            mesh_lib.all_reduce_tensors([total], self.data_group)
            denom = torch.clamp(total[0], min=1.0)
        with G.buffers_in_place(self.module):
            loss, probs, per_ex = objective.forward_loss(
                self.module, self.reg_layers, self.reg_lambdas, x, labels_oh,
                mask, self.class_weight, train=True, generator=gen_drop,
                denom=denom)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        mesh_lib.all_reduce_tensors(
            [p.grad for p in self.module.parameters() if p.grad is not None],
            self.data_group)
        self.optimizer.step()
        M.update_metrics(metrics, probs.detach(), labels_oh,
                         loss=per_ex.detach(), sample_mask=mask)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, images: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, metrics: M.MetricsState) -> None:
        """Validation loss and metrics of a uint8 batch (kernel B1 on
        CUDA), into ``metrics``."""
        self.module.eval()
        labels_oh = M.one_hot(labels, self.spec.n_classes)
        x = objective.eval_images(self.spec, images, self.compute_dtype)
        _, probs, per_ex = objective.forward_loss(
            self.module, self.reg_layers, self.reg_lambdas, x, labels_oh,
            mask, self.class_weight, train=False)
        M.update_metrics(metrics, probs, labels_oh, loss=per_ex,
                         sample_mask=mask)

    def run_epoch(self, dataset, batch_size: int, *, train: bool,
                  shuffle_seed: int = 0) -> Dict[str, float]:
        """One epoch of ``dataset``, shuffled by ``shuffle_seed`` when
        training: a device cache's as a graphed epoch, a streamed dataset's
        through the program of its batch shape
        (:meth:`run_epoch_streamed`), both uncaptured on the CPU or under
        gloo; under a mesh this rank's rows of each batch, the metrics
        summed over the data group at the end. Returns the epoch's
        metrics."""
        if isinstance(dataset, DeviceCachedDataset):
            return self._cached_epoch(dataset, batch_size, train=train,
                                      shuffle_seed=shuffle_seed)
        return self.run_epoch_streamed(dataset, batch_size, train=train,
                                       shuffle_seed=shuffle_seed)

    def run_epoch_per_step(self, dataset, batch_size: int, *, train: bool,
                           shuffle_seed: int = 0) -> Dict[str, float]:
        """One epoch dispatched op by op from the host, a step at a time
        (``train_step``, ``eval_step``; a device cache's batches are its
        gathers): the reference the streamed programs and the graphed
        epochs are held to. The same batches, draws and arithmetic."""
        metrics = M.init_metrics(self.spec.n_classes, device=self.device)

        def step(args, denom):
            if train:
                self.train_step(*args, metrics, denom=denom)
            else:
                self.eval_step(*args, metrics)

        self._host_batches(dataset, batch_size, train, shuffle_seed, step)
        self.epoch_mode = "per-step"
        M.reduce_metrics(metrics, self.data_group)
        return M.compute_metrics(metrics, self.class_names)

    def run_epoch_streamed(self, dataset, batch_size: int, *, train: bool,
                           shuffle_seed: int = 0) -> Dict[str, float]:
        """One epoch from the host (the streaming tier), each batch through
        :meth:`streamed_step`: copied into its program's fixed inputs, the
        program replayed (captured once a phase; run each batch on the CPU
        and under gloo). The metrics are read once, at the end."""
        metrics = self.streamed_metrics(train)
        M.reset_metrics(metrics)
        self._host_batches(
            dataset, batch_size, train, shuffle_seed,
            lambda args, denom: self.streamed_step(*args, train=train,
                                                   denom=denom))
        for prog in self.streamed_programs.values():
            prog.step.end_epoch()
        self.epoch_mode = f"streamed-{self.graph_mode}"
        M.reduce_metrics(metrics, self.data_group)
        return M.compute_metrics(metrics, self.class_names)

    def _host_batches(self, dataset, batch_size: int, train: bool,
                      shuffle_seed: int, step) -> None:
        """``step((images, labels, mask), denom)`` for each batch of
        ``dataset`` on the device: host batches go over through pinned
        buffers, batch k+1's copy issued before step k
        (:func:`drain_behind`). ``denom`` is the global batch's valid count
        under a mesh (the epoch table pads only its last batch), else
        None."""
        rows = (None if self.mesh is None
                else mesh_lib.batch_sharding(self.mesh, batch_size))
        n = len(dataset)
        staging = PinnedStaging(self.device)

        def launch(item):
            b, batch = item
            arrays = (batch.images, batch.labels, batch.mask)
            if isinstance(batch.images, torch.Tensor):  # a cache's gather
                return b, tuple(torch.as_tensor(a, device=self.device)
                                for a in arrays)
            return b, staging(*arrays)

        def consume(item):
            b, args = item
            denom = (None if rows is None or not train else
                     float(max(min(batch_size, n - b * batch_size), 1)))
            step(args, denom)

        drain_behind((launch(item) for item in enumerate(dataset.batches(
            batch_size, shuffle=train, seed=shuffle_seed, rows=rows))),
            consume)

    def streamed_step(self, images: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, *, train: bool,
                      denom: Optional[float] = None) -> StepGraph:
        """One training or evaluation step of a batch on the device through
        the program of its shapes (made on first use; the training ones
        anew each phase): the batch copied into the program's fixed
        inputs, the generators seeded from ``(seed, phase index, step)``,
        the program's step called (module note). Accumulates the kind's
        streamed metrics. Under a mesh a training step needs ``denom``,
        the global batch's valid count. Returns the program's step."""
        prog = self._streamed_program((images, labels, mask), train)
        for fixed, t in zip(prog.inputs, (images, labels, mask)):
            fixed.copy_(t)
        if train:
            if self.mesh is not None:
                if denom is None:
                    raise ValueError("a streamed training step under a mesh "
                                     "needs the global batch's denom")
                prog.denom.fill_(denom)
            self._seed_generators()
        prog.step()
        if train:
            self.step += 1
        return prog.step

    def streamed_summaries(self) -> Dict[str, Dict]:
        """:meth:`StepGraph.summary` of each streamed program, keyed
        ``"train BxHxWx3"`` or ``"eval BxHxWx3"``."""
        return {f"{'train' if key[0] else 'eval'} "
                f"{'x'.join(map(str, key[1][0]))}": prog.step.summary()
                for key, prog in self.streamed_programs.items()}

    def streamed_metrics(self, train: bool) -> M.MetricsState:
        """The metrics every streamed program of a kind (training or
        evaluation) sums into; :meth:`run_epoch_streamed` resets them at
        an epoch's start."""
        state = self._streamed_metrics.get(train)
        if state is None:
            state = self._streamed_metrics[train] = M.init_metrics(
                self.spec.n_classes, device=self.device)
        return state

    def _streamed_program(self, batch: Tuple[torch.Tensor, ...],
                          train: bool) -> _StreamedStep:
        key = (train,) + tuple((tuple(t.shape), t.dtype) for t in batch)
        prog = self.streamed_programs.get(key)
        if prog is not None:
            return prog
        inputs = tuple(torch.empty(t.shape, dtype=t.dtype,
                                   device=self.device) for t in batch)
        denom = torch.ones((), device=self.device)
        metrics = self.streamed_metrics(train)
        gens = self._train_generators() if train else ()
        on_mesh = self.mesh is not None

        def body():
            if train:
                self._train_core(*inputs, metrics, *gens,
                                 denom if on_mesh else None)
            else:
                self.eval_step(*inputs, metrics)

        prog = self.streamed_programs[key] = _StreamedStep(
            inputs, denom, StepGraph(
                body, self.device,
                name="streamed.train" if train else "streamed.eval",
                capture=capturable(self.device, [self.data_group]),
                generators=gens, modules=(self.module,)))
        return prog

    def _train_generators(self) -> Tuple[torch.Generator, ...]:
        """The augmentation and dropout generators every program's
        training step draws from (re-seeded before each step)."""
        if self._generators is None:
            self._generators = (torch.Generator(device=self.device),
                                torch.Generator(device=self.device))
        return self._generators

    def _seed_generators(self) -> None:
        for g, s in zip(self._train_generators(), step_seeds(
                self.seed, self.phase_idx, self.step)):
            g.manual_seed(int(s))

    def _cached_program(self, dataset: DeviceCachedDataset, batch_size: int,
                        train: bool) -> _CachedEpoch:
        """The graphed epoch's program for ``dataset`` at ``batch_size``
        (made on first use; the train one anew each phase)."""
        key = "train" if train else "eval"
        prog = self.epoch_programs.get(key)
        if (prog is not None and prog.dataset is dataset
                and prog.batch_size == batch_size):
            return prog
        tables = EpochTables((dataset.n_batches(batch_size), batch_size),
                             self.device)
        metrics = M.init_metrics(self.spec.n_classes, device=self.device)
        rows = (None if self.mesh is None
                else mesh_lib.batch_sharding(self.mesh, batch_size))
        groups = [self.data_group]
        if isinstance(dataset, ShardedDeviceCachedDataset):
            groups.append(dataset.group if dataset.group is not None
                          else mesh_lib.world_group())
        gens = self._train_generators() if train else ()

        def body():
            idx, mask_all = tables.row()
            images, labels = dataset.gather_rows(idx, rows)
            mask = mask_all if rows is None else mask_all[rows]
            if not train:
                self.eval_step(images, labels, mask, metrics)
            else:
                # Under a mesh: the global batch's valid rows.
                denom = (None if rows is None
                         else torch.clamp(mask_all.sum(), min=1.0))
                self._train_core(images, labels, mask, metrics, *gens, denom)
            tables.advance()

        prog = _CachedEpoch(dataset, batch_size, tables, metrics, StepGraph(
            body, self.device, name=key,
            capture=capturable(self.device, groups), generators=gens,
            modules=(self.module,)))
        self.epoch_programs[key] = prog
        return prog

    def _cached_epoch(self, dataset: DeviceCachedDataset, batch_size: int,
                      *, train: bool, shuffle_seed: int) -> Dict[str, float]:
        """The graphed epoch (module note): the tables uploaded once, one
        replay (or uncaptured run) a batch, the metrics read once. Spans:
        ``train.epoch`` around it, and inside ``train.epoch.tables``,
        ``.reset``, ``.steps`` (the replays' spans inside) and
        ``.readback``, in turn."""
        with annotate("train.epoch"):
            prog = self._cached_program(dataset, batch_size, train)
            with annotate("train.epoch.tables"):
                idx, mask = dataset.epoch_index_table(
                    batch_size, shuffle=train, seed=shuffle_seed)
                prog.tables.load(idx, mask)
            with annotate("train.epoch.reset"):
                M.reset_metrics(prog.metrics)
            with annotate("train.epoch.steps"):
                for _ in range(prog.tables.n_steps):
                    if train:
                        self._seed_generators()
                    prog.step()
                    if train:
                        self.step += 1
            with annotate("train.epoch.readback"):
                prog.step.end_epoch()
                self.epoch_mode = prog.step.mode
                M.reduce_metrics(prog.metrics, self.data_group)
                return M.compute_metrics(prog.metrics, self.class_names)

    # ------------------------------------------------------------------
    def _save_resume(self, path: str, *, epoch: int, epoch_in_phase: int,
                     ctl: CallbackState, best_vars: Optional[StateDict],
                     phase_done: bool) -> None:
        save_resume(path, self.RESUME_FILE,
                    {"model": self.module.state_dict(),
                     "optimizer": self.optimizer.state_dict(),
                     "best_vars": best_vars, "step": self.step},
                    {"epoch": epoch, "phase_idx": self.phase_idx,
                     "epoch_in_phase": int(epoch_in_phase),
                     "best_val": float(ctl.best_val),
                     "best_plateau": float(ctl.best_plateau),
                     "wait": int(ctl.wait),
                     "plateau_wait": int(ctl.plateau_wait),
                     "phase_done": bool(phase_done)})

    def fit(self, train_ds, val_ds, *, batch_size: int, epochs: int,
            patience: int = 15, variables: Optional[StateDict] = None,
            verbose: bool = True, tracker=None,
            callbacks: Optional[List] = None,
            checkpoint_dir: Optional[str] = None,
            resume: bool = False) -> Tuple[StateDict, List[EpochLog]]:
        """Run the phase plan from ``variables`` (a state dict; default the
        module's seeded initialization). Returns the final weights (a CPU
        state dict) and the history.

        :param checkpoint_dir: save the whole train state there every
            epoch (params, statistics, optimizer, callback counters, best
            weights).
        :param resume: continue from the checkpoint in ``checkpoint_dir``.
        """
        history: List[EpochLog] = []
        epoch = 0
        progress = payload = None
        if resume and checkpoint_dir:
            loaded = load_resume(checkpoint_dir, self.RESUME_FILE)
            if loaded is not None:
                payload, progress = loaded
                epoch = progress["epoch"] + 1

        for phase_idx, phase in enumerate(self.spec.phases):
            if progress and phase_idx < progress["phase_idx"]:
                continue  # the checkpoint covers the whole phase
            ctl = CallbackState(patience=patience,
                                plateau_patience=max(1, patience // 2))
            best_vars: Optional[StateDict] = None
            epoch_in_phase, phase_done = 0, False
            self.begin_phase(phase_idx, phase, variables)
            variables = None
            if progress and phase_idx == progress["phase_idx"]:
                epoch_in_phase = progress.get("epoch_in_phase", 0) + 1
                phase_done = progress.get("phase_done", False)
                self.module.load_state_dict(payload["model"])
                self.optimizer.load_state_dict(payload["optimizer"])
                self.step = int(payload["step"])
                best_vars = payload["best_vars"]
                ctl.best_val = progress["best_val"]
                ctl.best_plateau = progress.get("best_plateau",
                                                progress["best_val"])
                ctl.wait = progress["wait"]
                ctl.plateau_wait = progress["plateau_wait"]
                progress = None

            # Fixed-length phases subtract the epochs already run; open
            # ones budget from the global epoch count; a phase saved as
            # early-stopped never runs again, and hands on its best
            # weights.
            remaining = (phase.epochs - epoch_in_phase
                         if phase.epochs is not None
                         else max(0, epochs - epoch))
            if phase_done:
                if best_vars is not None:
                    self.module.load_state_dict(best_vars)
                continue

            stopped = False
            for _ in range(remaining):
                t0 = time.time()
                train_m = self.run_epoch(train_ds, batch_size, train=True,
                                         shuffle_seed=epoch)
                val_m: Dict[str, float] = {}
                if val_ds is not None and len(val_ds):
                    val_m = self.run_epoch(val_ds, batch_size, train=False)
                log = EpochLog(epoch=epoch, phase=phase.name, train=train_m,
                               val=val_m,
                               lr=get_learning_rate(self.optimizer),
                               seconds=time.time() - t0)
                history.append(log)
                if tracker is not None:
                    tracker.log_epoch(log)
                for cb in callbacks or []:
                    cb.on_epoch_end(epoch, self.module.state_dict())
                if verbose and mesh_lib.is_main():
                    vm = {f"val_{k}": round(v, 4) for k, v in val_m.items()}
                    print(f"[{phase.name}] epoch {epoch}: "
                          f"loss={train_m['loss']:.4f} "
                          f"acc={train_m['accuracy']:.4f} "
                          f"auc={train_m['auc']:.4f} {vm} "
                          f"({log.seconds:.1f}s)", flush=True)
                epoch += 1

                monitored = val_m.get("loss")
                stopped = False
                if monitored is not None:
                    cur = get_learning_rate(self.optimizer) or 0.0
                    improved, stopped, new_lr = ctl.update(monitored, cur)
                    if improved:
                        best_vars = _copy_state(self.module)
                    if new_lr is not None:
                        scale_learning_rate(self.optimizer, new_lr / cur)
                        if verbose and mesh_lib.is_main():
                            print(f"  ReduceLROnPlateau: lr -> {new_lr:.2e}")
                    if stopped and verbose and mesh_lib.is_main():
                        print(f"  EarlyStopping at epoch {epoch - 1} "
                              f"(best val_loss {ctl.best_val:.4f})")
                if checkpoint_dir:
                    self._save_resume(checkpoint_dir, epoch=epoch - 1,
                                      epoch_in_phase=epoch_in_phase, ctl=ctl,
                                      best_vars=best_vars,
                                      phase_done=stopped)
                if stopped:
                    break
                epoch_in_phase += 1

            # Keras restore_best_weights restores only when early stopping
            # triggers; a phase that runs its whole budget keeps its final
            # weights (cutoffvgg16's extract hands its last epoch on).
            if stopped and best_vars is not None:
                self.module.load_state_dict(best_vars)
        self.release_programs()  # the graphs and their memory
        return self.state(), history
