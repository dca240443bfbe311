"""Trial-parallel training (port of the JAX package's
``parallel/trial_parallel.py``): F same-architecture models, the folds of
a cross-validation or the trials of a learning-rate search, trained in
lock-step as one stacked program on one device.

Every parameter and buffer is stacked along a leading trial axis, and the
step runs the model under ``torch.func.vmap`` over
``torch.func.functional_call``, the counterpart of the JAX package's
``jax.vmap``. Each op of a step then launches once for all F trials:
vmap's rules turn a conv with per-trial weights into one grouped conv, a
dense layer into one batched matmul, and kernel B2 launches once over all
trials' channels (``ops/depthwise.py::depthwise_trials``); the optimizer
(``models/common.py::StackedOptimizer``) and the metrics
(``ops/metrics.py::update_stacked_metrics``) update every trial's tensors
at once, and a validation batch goes through kernel B1 as one ``[F * B]``
batch. The losses of the trials are independent, so one backward of their
sum gives every trial its own gradients.

Semantics kept from the JAX package:

* the frame table lives once on the device (``DeviceCachedDataset``) and
  a batch is a gather by an ``[F, B]`` index table; ragged per-trial lists
  are padded by wrapping around each trial's own rows
  (:func:`pad_index_table`), so padded rows, masked out of the loss and
  the metrics, still put real frames of the trial's own data into a
  training batch norm's statistics;
* per-trial class weights ``[F, C]`` and output biases ``[F, C]``;
* EarlyStopping (min_delta 0) and ReduceLROnPlateau (min_delta 1e-4,
  factor 0.5, a factor floor of ``1e-8 / lr``) as vectorized host logic: a
  per-trial ``active`` flag gates the updates (a stopped trial keeps its
  state and keeps stepping), a per-trial ``lr_factor`` scales them, the
  best weights follow a per-trial improvement mask, and at a phase's end
  a trial gets its best weights back only when its patience ran out;
* the callback state resets every phase, the weights carry over
  (cutoffvgg16's ``extract`` -> ``finetune``); each epoch's training order
  is ``np.random.RandomState(epoch)``'s permutation of each trial's rows;
* with a checkpoint directory the whole stacked state is saved every epoch
  (``utils/resume.py``, the port's own format) and a resumed fit lands
  where the uninterrupted one does, bit for bit.

The randomness of a step is drawn outside the vmapped forward, per trial:
trial t's augmentation parts and dropout masks come from CPU generators
seeded from ``(seed, phase, step, t)`` (:func:`trial_generators`), as the
serial ``Trainer``'s come from ``(seed, phase, step)``.

An epoch is a graphed epoch (``train/graphed.py``; the JAX package's
``make_epoch_fns`` scans the vmapped step over the ``[nb, F, B]`` tables):
the tables go over once, each step gathers its ``[F, B]`` batch from its
device row, and the stacked step, captured once a phase (and once for
evaluation), is replayed for every batch. Before each replay the step's
host draws are copied into fixed device buffers through pinned memory;
``lr_factor`` and ``active`` are device tensors set once an epoch, and the
optimizer's counts live on the device. On the CPU and under gloo the same
step runs uncaptured; :meth:`ParallelFoldTrainer.run_epoch_per_step`
dispatches it from the host a batch at a time.

With a device mesh (``parallel/mesh.py``), as in the JAX package, the
trial axis shards over the mesh's ``trial`` axis and each trial's batch
over its ``data`` axis: a rank holds F/T trials (all F, replicated, when T
does not divide F, said so) and takes its rows of every batch; B2's one
stacked launch then covers its ``F/T * C`` channels. Its batch norms take
each trial's global batch statistics (one ``all_reduce`` for all its
trials), its augmentation and dropout are drawn for each trial's global
batch and its rows kept, its loss divides by the global valid count, its
gradients and metrics are summed over the data group, and the per-trial
metrics are gathered over the trial group, so the host-side callbacks see
all F trials alike on every rank. The frame table lives whole on every
rank, or split over the data axis (``shard_dataset``;
``data/pipeline.py::ShardedDeviceCachedDataset``). The checkpoint and the
returned weights are gathered to all F trials; rank 0 writes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.data.augment import (Parts,
                                                  affine_params_from_config)
from ab_line_classifier_torch.data.pipeline import (
    DeviceCachedDataset, PinnedStaging, ShardedDeviceCachedDataset,
    device_cache_budget)
from ab_line_classifier_torch.models.common import (ModelSpec,
                                                    StackedOptimizer,
                                                    TrainPhase, trial_vector)
from ab_line_classifier_torch.models.preprocess import get_preprocess_fn
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.train import objective
from ab_line_classifier_torch.train.graphed import (EpochTables, StepGraph,
                                                    capturable, step_seeds)
from ab_line_classifier_torch.utils.resume import load_resume, save_resume

Stacked = Dict[str, torch.Tensor]


def pad_index_table(index_lists: List[np.ndarray],
                    pad_to: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged per-trial index lists -> a padded ``[F, N]`` table and its
    validity mask (a copy of the JAX package's). Padding cycles each
    trial's OWN indices (wraparound): padded rows are masked out of the
    loss and the metrics, but they enter a training batch norm's batch
    statistics, which must see real frames of the trial's own data. An
    empty list raises."""
    for f, ix in enumerate(index_lists):
        if len(ix) == 0:
            raise ValueError(
                f"fold/trial {f} has an empty index list; every fold needs "
                f"at least one frame (dataset too small for this split?)")
    n = pad_to or max(len(ix) for ix in index_lists)
    table = np.zeros((len(index_lists), n), np.int32)
    mask = np.zeros((len(index_lists), n), np.float32)
    for f, ix in enumerate(index_lists):
        table[f, :len(ix)] = ix
        if len(ix) < n:
            reps = np.tile(ix, -(-(n - len(ix)) // len(ix)))
            table[f, len(ix):] = reps[:n - len(ix)]
        mask[f, :len(ix)] = 1.0
    return table, mask


def trial_generators(seed: int, phase_idx: int, step: int, n_trials: int
                     ) -> List[Tuple[torch.Generator, torch.Generator]]:
    """Trial t's augmentation and dropout generators for one step (on the
    CPU), seeded from ``(seed, phase_idx, step, t)``."""
    return [tuple(torch.Generator().manual_seed(int(s))
                  for s in step_seeds(seed, phase_idx, step, t))
            for t in range(n_trials)]


@dataclasses.dataclass
class _StackedEpoch:
    """A graphed stacked epoch's program: train (with its optimizer) or
    eval over one cache at one table shape, its tables, metrics, the
    device buffers the host fills before each replay (``lr_factor`` and
    ``active`` once an epoch, the draws each step) and its step."""

    owners: Tuple
    shape: Tuple[int, ...]
    tables: EpochTables
    metrics: M.MetricsState
    gates: Optional[torch.Tensor]
    draws: List[torch.Tensor]
    staging: PinnedStaging
    step: StepGraph


def _stack(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Per-trial tensors stacked on a leading axis on ``device``; a 4-D
    (conv) weight keeps each trial's slice channels_last, as the serial
    trainer's module holds it."""
    s = torch.stack([t.detach() for t in tensors]).to(device)
    if s.ndim == 5:
        s = s.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    return s


def trial_state(stacked: Dict[str, Stacked], t: int
                ) -> Dict[str, torch.Tensor]:
    """Trial ``t``'s state dict (on the CPU) of a stacked ``{"params",
    "buffers"}`` pair, as :meth:`ParallelFoldTrainer.fit` returns it."""
    out = {}
    for part in stacked.values():
        out.update({k: v[t].detach().to("cpu", copy=True)
                    for k, v in part.items()})
    return out


class ParallelFoldTrainer:
    """Train F same-architecture models on F index sets of one frame table
    at once, on ``device`` (``cuda`` unless it says otherwise), over the
    ranks of ``mesh`` when given (this rank's device).

    ``class_weights`` and ``output_biases`` are ``[F, C]`` (all F trials,
    on every rank); ``compute_dtype`` bfloat16 trains mixed precision
    (float32 parameters, per-layer bfloat16 casts); ``seed`` seeds each
    trial's initialization and every step's generators. ``trials`` is the
    slice of the F trials this rank holds; the stacked tensors of
    :meth:`train_step` and :meth:`eval_step` are those trials' and this
    rank's rows of their batches."""

    RESUME_FILE = "trial_state.pt"

    def __init__(self, spec: ModelSpec, n_folds: int, *,
                 class_weights: np.ndarray,
                 output_biases: Optional[np.ndarray] = None,
                 aug_config: Optional[Dict] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 progress_label: str = "folds", device=None, mesh=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.n_folds = int(n_folds)
        self.mesh = mesh
        n_trial = mesh_lib.axis_size(mesh, mesh_lib.TRIAL_AXIS)
        if self.n_folds % n_trial:
            # The stacked trial axis shards over 'trial' only when it
            # divides; otherwise every rank holds every trial (batches
            # still shard over 'data').
            if mesh_lib.is_main():
                print(f"trial axis ({n_trial}) does not divide "
                      f"{self.n_folds} folds/trials; replicating fold state "
                      f"across the mesh")
            self.trial_group = None
        else:
            self.trial_group = mesh_lib.axis_group(mesh, mesh_lib.TRIAL_AXIS)
        self.trials = mesh_lib.trial_replicated(mesh, self.n_folds)
        self.data_group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
        self.shard = (mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS),
                      mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS))
        self.progress_label = progress_label
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.preprocess_fn = get_preprocess_fn(spec.preprocess_mode)
        self.aug_params = (affine_params_from_config(aug_config)
                           if aug_config else None)
        self.class_weights = torch.as_tensor(
            np.asarray(class_weights, np.float32)[self.trials]).to(
                self.device)
        self.output_biases = (None if output_biases is None else
                              torch.as_tensor(np.asarray(output_biases,
                                                         np.float32)))
        self.reg_layers = tuple(spec.activity_regularizers)
        self.reg_lambdas = [spec.activity_regularizers[n]
                            for n in self.reg_layers]
        # One module, never stepped itself: the stacked tensors go in
        # through functional_call.
        self.module = spec.logits_module(capture=self.reg_layers).to(
            self.device, memory_format=torch.channels_last)
        G.set_compute_dtype(self.module,
                            None if compute_dtype == torch.float32
                            else compute_dtype)
        G.set_data_parallel(self.module, self.data_group)
        # Found on a CPU copy: a pass on the device would launch its
        # kernels outside any step.
        self.drop_shapes = G.dropout_mask_shapes(
            spec.logits_module(), torch.zeros((1,) + tuple(spec.input_shape)))
        self.phase_idx = 0
        self.step = 0
        #: The path of the last epoch: ``graphed`` or ``uncaptured`` (the
        #: CPU, a gloo group), or ``per-step``.
        self.epoch_mode: Optional[str] = None
        #: The graphed epochs' programs, ``train`` (this phase's) and
        #: ``eval``; released at the end of :meth:`fit`.
        self.epoch_programs: Dict[str, _StackedEpoch] = {}

    # ------------------------------------------------------------------
    def trial_seeds(self) -> List[int]:
        """Each trial's initialization seed, from ``(seed, trial)``."""
        return [int(np.random.SeedSequence([self.seed, t]).generate_state(
            1, np.uint32)[0]) for t in range(self.n_folds)]

    def init_stacked(self, warm_start=None) -> Tuple[Stacked, Stacked]:
        """Stacked per-trial initialization of this rank's trials:
        ``(params, buffers)``, trial t from its own seeded generator; the
        output biases (``[F, C]``) on the logits layer; then
        ``warm_start``, a ``(state_dict, layer_names)`` pair, broadcast into
        every trial over the named layers (all, when ``layer_names`` is
        None), as each fold of the serial run starts from the same
        pretrained file."""
        local = range(self.n_folds)[self.trials]
        seeds = self.trial_seeds()
        states = [self.spec.logits_module(
            generator=torch.Generator().manual_seed(seeds[t])).state_dict()
            for t in local]
        if self.output_biases is not None:
            key = f"{self.spec.logits_layer}.bias"
            for t, sd in zip(local, states):
                sd[key] = self.output_biases[t].to(sd[key].dtype)
        if warm_start is not None:
            wsd, names = warm_start
            for k, v in wsd.items():
                if k in states[0] and (names is None
                                       or k.split(".", 1)[0] in names):
                    for sd in states:
                        sd[k] = v.to(sd[k].dtype)
        param_names = {n for n, _ in self.module.named_parameters()}
        stacked = {k: _stack([sd[k] for sd in states], self.device)
                   for k in states[0]}
        params = {k: v for k, v in stacked.items() if k in param_names}
        buffers = {k: v for k, v in stacked.items() if k not in param_names}
        return params, buffers

    def begin_phase(self, phase_idx: int, phase: TrainPhase,
                    params: Stacked) -> StackedOptimizer:
        """Start ``phase``: its frozen batch norms run in inference mode,
        a fresh optimizer (its trainability on ``params``), step 0."""
        self.module.set_inference_bn(self.spec.frozen_bn_layers(phase))
        self.phase_idx, self.step = phase_idx, 0
        self.epoch_programs.pop("train", None)
        return StackedOptimizer(phase, params)

    # ------------------------------------------------------------------
    def _dropout_masks(self, generators, batch: int, device) -> Stacked:
        """Each trial's keep masks, drawn for its global batch (``batch``
        times the data axis), this rank's rows kept, on ``device``."""
        i, count = self.shard
        masks = {}
        for name, shape in self.drop_shapes.items():
            keep = 1.0 - self.module._modules[name].rate
            masks[name] = torch.stack([
                torch.rand([batch * count] + shape[1:],
                           generator=g)[i * batch:(i + 1) * batch] < keep
                for _, g in generators]).to(device)
        return masks

    def _draws(self, batch: int, hw: Tuple[int, int], device
               ) -> Tuple[Optional[Parts], Stacked]:
        """This step's augmentation parts (None without augmentation) and
        dropout masks for this rank's trials, ``batch`` rows each, drawn
        on the host from :func:`trial_generators` and put on ``device``."""
        gens = trial_generators(self.seed, self.phase_idx, self.step,
                                self.n_folds)[self.trials]
        parts = (objective.stacked_parts([g for g, _ in gens], batch, hw,
                                         device, self.aug_params,
                                         shard=self.shard)
                 if self.aug_params else None)
        return parts, self._dropout_masks(gens, batch, device)

    def _forward(self, params, buffers, **kw):
        """A forward callable of one trial's slice, for
        ``objective.forward_loss`` (the ``generator`` it passes is not
        used: masks come in ``kw``)."""
        def fwd(x, generator=None):
            return functional_call(self.module, {**params, **buffers}, (x,),
                                   kw)
        return fwd

    def train_step(self, params: Stacked, buffers: Stacked,
                   opt: StackedOptimizer, images: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   lr_factor, active, metrics: M.MetricsState,
                   denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step of every trial on a stacked uint8 batch ``[F, B, H, W,
        3]`` on the device (labels and mask ``[F, B]``): augment, vmapped
        forward and loss, one backward, the stacked update gated by
        ``lr_factor * active`` (``[F]`` host arrays or device tensors); a
        trial's new batch-norm statistics only where it is active.
        Accumulates ``metrics`` (stacked). Returns the per-trial losses
        ``[F]``.

        Under a mesh: this rank's trials and rows; ``denom`` ``[F]`` is
        each trial's global valid count (summed over the data group when
        not given); the losses are this rank's shares."""
        parts, drop = self._draws(images.shape[1], tuple(images.shape[2:4]),
                                  self.device)
        loss = self._train_core(params, buffers, opt, images, labels, mask,
                                trial_vector(lr_factor, self.device),
                                trial_vector(active, self.device), metrics,
                                denom, parts, drop)
        self.step += 1
        return loss

    def _train_core(self, params, buffers, opt, images, labels, mask,
                    lr_factor: torch.Tensor, active: torch.Tensor, metrics,
                    denom, parts: Optional[Parts], drop: Stacked
                    ) -> torch.Tensor:
        """:meth:`train_step`'s device work, from given draws and device
        gates: no host value, so a graphed epoch captures it."""
        f, b = images.shape[:2]
        x = objective.prepare_stacked_images(
            self.preprocess_fn, self.aug_params, self.compute_dtype, images,
            parts)
        labels_oh = M.one_hot(labels.reshape(-1), self.spec.n_classes).view(
            f, b, -1)
        self.module.train()
        if denom is None:
            denom = mask.to(torch.float32).sum(-1)
            mesh_lib.all_reduce_tensors([denom], self.data_group)
        denom = torch.clamp(denom, min=1.0)

        def one(p, bufs, x, loh, m, cw, dm, dn):
            stats = {}
            loss, probs, per_ex = objective.forward_loss(
                self._forward(p, bufs, dropout_masks=dm, bn_stats=stats),
                self.reg_layers, self.reg_lambdas, x, loh, m, cw,
                train=True, denom=dn)
            return loss, probs, per_ex, stats

        loss, probs, per_ex, stats = vmap(one)(
            params, buffers, x, labels_oh, mask, self.class_weights, drop,
            denom)
        for p in params.values():
            p.grad = None
        loss.sum().backward()
        mesh_lib.all_reduce_tensors(
            [p.grad for p in params.values() if p.grad is not None],
            self.data_group)
        opt.step(params, lr_factor, active)
        with torch.no_grad():
            on = active > 0
            for name, (mean, var) in stats.items():
                for key, new in ((f"{name}.running_mean", mean),
                                 (f"{name}.running_var", var)):
                    old = buffers[key]
                    keep = on.view((-1,) + (1,) * (old.ndim - 1))
                    old.copy_(torch.where(keep, new, old))
        M.update_stacked_metrics(metrics, probs.detach(), labels_oh,
                                 per_ex.detach(), mask)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, params: Stacked, buffers: Stacked,
                  images: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, metrics: M.MetricsState) -> None:
        """Every trial's validation loss and metrics of a stacked uint8
        batch, into ``metrics``: the ``F * B`` frames through kernel B1
        (its plain version on the CPU) in one launch, then the vmapped
        forward."""
        f, b = images.shape[:2]
        x = objective.eval_stacked_images(self.spec, images,
                                          self.compute_dtype)
        labels_oh = M.one_hot(labels.reshape(-1), self.spec.n_classes).view(
            f, b, -1)
        self.module.eval()

        def one(p, bufs, x, loh, m):
            _, probs, per_ex = objective.forward_loss(
                self._forward(p, bufs, bn_stats={}), self.reg_layers,
                self.reg_lambdas, x, loh, m, None, train=False)
            return probs, per_ex

        probs, per_ex = vmap(one)(params, buffers, x, labels_oh, mask)
        M.update_stacked_metrics(metrics, probs, labels_oh, per_ex, mask)

    # ------------------------------------------------------------------
    def _batch_tables(self, index_lists, batch_size: int):
        """Ragged per-trial index lists (all F) -> this rank's trials'
        ``[nb, F, B]`` index and mask tables on the device; all padding
        (to the longest list and to the batch multiple) wraps around
        (:func:`pad_index_table`)."""
        f = self.n_folds
        n = max(len(ix) for ix in index_lists)
        nb = -(-n // batch_size)
        table, tmask = pad_index_table(index_lists, pad_to=nb * batch_size)
        idx = table.reshape(f, nb, batch_size).transpose(1, 0, 2)
        msk = tmask.reshape(f, nb, batch_size).transpose(1, 0, 2)
        idx, msk = idx[:, self.trials], msk[:, self.trials]
        return (torch.as_tensor(np.ascontiguousarray(idx)).to(self.device),
                torch.as_tensor(np.ascontiguousarray(msk)).to(self.device))

    def run_epoch(self, params, buffers, opt, cache: DeviceCachedDataset,
                  idx_tab, mask_tab, *, train: bool, lr_factor=None,
                  active=None) -> List[Dict[str, float]]:
        """One epoch over ``[nb, F, B]`` tables (this rank's trials, whole
        batches: it takes its rows) as a graphed epoch (uncaptured on the
        CPU or under gloo); every trial's metrics (all F)."""
        prog = self._program(params, buffers, opt, cache,
                             tuple(idx_tab.shape), train)
        prog.tables.load(idx_tab, mask_tab)
        M.reset_metrics(prog.metrics)
        if train:
            prog.gates.copy_(torch.as_tensor(np.stack([
                np.asarray(lr_factor, np.float32)[self.trials],
                np.asarray(active, np.float32)[self.trials]])))
        b = len(range(idx_tab.shape[-1])[self._rows(idx_tab.shape[-1])])
        for _ in range(prog.tables.n_steps):
            if train:
                parts, drop = self._draws(b, tuple(cache.img_dim),
                                          torch.device("cpu"))
                prog.staging(*(parts or ()), *drop.values(), out=prog.draws)
            prog.step()
            if train:
                self.step += 1
        prog.step.end_epoch()
        self.epoch_mode = prog.step.mode
        M.reduce_metrics(prog.metrics, self.data_group)
        return M.compute_stacked_metrics(self._gather_trials(prog.metrics))

    def run_epoch_per_step(self, params, buffers, opt,
                           cache: DeviceCachedDataset, idx_tab, mask_tab, *,
                           train: bool, lr_factor=None, active=None
                           ) -> List[Dict[str, float]]:
        """:meth:`run_epoch` dispatched from the host a step at a time:
        the same batches, draws and arithmetic."""
        metrics = M.init_metrics(self.spec.n_classes, device=self.device,
                                 trials=len(idx_tab[0]))
        rows = self._rows(idx_tab.shape[-1])
        for idx, msk in zip(idx_tab, mask_tab):
            images, labels = cache.gather_rows(idx, rows)
            if train:
                self.train_step(params, buffers, opt, images, labels,
                                msk[:, rows], lr_factor[self.trials],
                                active[self.trials], metrics,
                                denom=msk.sum(-1))
            else:
                self.eval_step(params, buffers, images, labels, msk[:, rows],
                               metrics)
        self.epoch_mode = "per-step"
        M.reduce_metrics(metrics, self.data_group)
        return M.compute_stacked_metrics(self._gather_trials(metrics))

    def _rows(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row batch (all without a
        mesh)."""
        return (slice(None) if self.mesh is None
                else mesh_lib.batch_sharding(self.mesh, batch))

    def _program(self, params, buffers, opt, cache, shape, train: bool
                 ) -> _StackedEpoch:
        """The graphed epoch's program (made on first use; the train one
        anew each phase)."""
        key = "train" if train else "eval"
        owners = (params, buffers, opt, cache)
        prog = self.epoch_programs.get(key)
        if (prog is not None and prog.shape == shape
                and all(a is b for a, b in zip(prog.owners, owners))):
            return prog
        tables = EpochTables(shape, self.device)
        metrics = M.init_metrics(self.spec.n_classes, device=self.device,
                                 trials=shape[1])
        rows = self._rows(shape[-1])
        groups = [self.data_group]
        if isinstance(cache, ShardedDeviceCachedDataset):
            groups.append(cache.group if cache.group is not None
                          else mesh_lib.world_group())
        gates = draws = None
        n_parts = 0
        if train:
            gates = torch.zeros((2, shape[1]), dtype=torch.float32,
                                device=self.device)
            b = len(range(shape[-1])[rows])
            parts, drop = self._draws(b, tuple(cache.img_dim),
                                      torch.device("cpu"))
            host = list(parts or ()) + list(drop.values())
            draws = [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                     for t in host]
            n_parts = len(parts or ())
            names = list(drop)

        def body():
            idx, msk = tables.row()
            images, labels = cache.gather_rows(idx, rows)
            if not train:
                self.eval_step(params, buffers, images, labels, msk[:, rows],
                               metrics)
            else:
                self._train_core(
                    params, buffers, opt, images, labels, msk[:, rows],
                    gates[0], gates[1], metrics, msk.sum(-1),
                    Parts(*draws[:n_parts]) if n_parts else None,
                    dict(zip(names, draws[n_parts:])))
            tables.advance()

        prog = _StackedEpoch(owners, shape, tables, metrics, gates,
                             draws or [], PinnedStaging(self.device),
                             StepGraph(body, self.device,
                                       capture=capturable(self.device,
                                                          groups)))
        self.epoch_programs[key] = prog
        return prog

    def _gather_trials(self, tree):
        """Every tensor of ``tree`` (dicts, a :class:`MetricsState`), this
        rank's trials along dim 0, gathered over the trial group to all F
        trials, on every rank."""
        if isinstance(tree, M.MetricsState):
            return M.MetricsState(**self._gather_trials(vars(tree)))
        if isinstance(tree, dict):
            return {k: self._gather_trials(v) for k, v in tree.items()}
        if self.trial_group is None or tree is None:
            return tree
        return mesh_lib.all_gather_rows(tree, self.trial_group)

    @staticmethod
    def _history_to_host(history):
        return [{k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                     else v) for k, v in h.items()} for h in history]

    @staticmethod
    def _history_from_host(records):
        return [{k: (np.asarray(v) if isinstance(v, list) else v)
                 for k, v in h.items()} for h in records]

    def fit(self, frames, labels: Optional[np.ndarray],
            train_idx: List[np.ndarray], val_idx: List[np.ndarray], *,
            batch_size: int, epochs: int, patience: int = 15,
            lr_factors=None, verbose: bool = True,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            warm_start=None, shard_dataset="auto"
            ) -> Tuple[Dict[str, Stacked], List[Dict]]:
        """Train every trial through the phase plan. ``frames`` is a
        :class:`DeviceCachedDataset` (``labels`` unused) or a uint8 ``[N, H,
        W, 3]`` array with its ``labels``, uploaded once; ``train_idx`` /
        ``val_idx`` are each trial's rows of it. Returns ``({"params",
        "buffers"}`` stacked end-of-plan weights of all F trials, the
        history: one dict of per-trial arrays per epoch``)``; a resumed
        fit's history starts at epoch 0, the checkpointed epochs restored.

        :param shard_dataset: under a mesh with a ``data`` axis, an array
            ``frames`` is split over it (``True``; ``"auto"``: where it
            exceeds one device's cache budget) or held whole (``False``).

        :param lr_factors: per-trial learning-rate multipliers: one ``[F]``
            array for every phase, or ``{phase_name: [F]}``.
        :param checkpoint_dir: save the whole stacked state there every
            epoch; ``resume`` continues from it.
        :param warm_start: a ``(state_dict, layer_names)`` overlay for
            every trial's initialization (:meth:`init_stacked`).
        """
        f = self.n_folds
        if isinstance(frames, DeviceCachedDataset):
            cache = frames
        elif self.data_group is not None and shard_dataset is not False and (
                shard_dataset is True
                or frames.nbytes > device_cache_budget(self.device)):
            cache = ShardedDeviceCachedDataset.from_arrays(
                frames, labels, self.device, self.mesh)
        else:
            cache = DeviceCachedDataset.from_arrays(frames, labels,
                                                    self.device)
        v_idx, v_mask = self._batch_tables(val_idx, batch_size)

        history: List[Dict] = []
        best_val = np.full(f, np.inf)
        best_plateau = np.full(f, np.inf)
        wait = np.zeros(f, int)
        plateau_wait = np.zeros(f, int)
        plateau_patience = max(1, patience // 2)
        carry = None
        epoch = 0

        progress = payload = None
        if resume and checkpoint_dir:
            loaded = load_resume(checkpoint_dir, self.RESUME_FILE)
            if loaded is not None:
                payload, progress = loaded
                epoch = progress["epoch"] + 1
                history = self._history_from_host(progress["history"])

        for phase_idx, phase in enumerate(self.spec.phases):
            if progress and phase_idx < progress["phase_idx"]:
                continue  # the checkpoint covers the whole phase
            restoring = bool(progress
                             and phase_idx == progress["phase_idx"])
            epoch_in_phase, phase_done = 0, False
            if restoring:
                epoch_in_phase = progress["epoch_in_phase"] + 1
                phase_done = progress["phase_done"]
            phase_epochs = (phase.epochs - epoch_in_phase
                            if phase.epochs is not None
                            else max(0, epochs - epoch))
            if phase_done:
                phase_epochs = 0
            if phase_epochs <= 0 and not restoring:
                continue
            if carry is not None:
                params, buffers = carry            # the phase hand-off
            else:
                params, buffers = self.init_stacked(
                    None if restoring else warm_start)
            opt = self.begin_phase(phase_idx, phase, params)
            best = None                            # per phase, as Keras fit
            best_val[:] = np.inf
            best_plateau[:] = np.inf
            wait[:] = 0
            plateau_wait[:] = 0
            if isinstance(lr_factors, dict):
                if phase.name not in lr_factors:
                    raise ValueError(
                        f"lr_factors dict is missing phase {phase.name!r} "
                        f"(has {sorted(lr_factors)}); keys must be phase "
                        f"names, not hyperparameter names")
                phase_factors = lr_factors[phase.name]
            else:
                phase_factors = lr_factors
            lr_factor = (np.asarray(phase_factors, np.float32).copy()
                         if phase_factors is not None
                         else np.ones(f, np.float32))
            active = np.ones(f, np.float32)

            if restoring:
                self._restore(payload, params, buffers, opt)
                best = payload["best"]
                if best is not None:
                    best = {k: {n: t[self.trials].to(self.device)
                                for n, t in v.items()}
                            for k, v in best.items()}
                lr_factor = np.asarray(progress["lr_factor"], np.float32)
                active = np.asarray(progress["active"], np.float32)
                best_val = np.asarray(progress["best_val"], np.float64)
                best_plateau = np.asarray(progress["best_plateau"],
                                          np.float64)
                wait = np.asarray(progress["wait"], int)
                plateau_wait = np.asarray(progress["plateau_wait"], int)
                progress = None                    # later phases run anew
            if phase_epochs <= 0:
                carry = self._end_vars(params, buffers, best, wait, patience)
                continue

            for _ in range(phase_epochs):
                t0 = time.time()
                rng = np.random.RandomState(epoch)
                shuffled = [rng.permutation(ix) for ix in train_idx]
                idx_tab, mask_tab = self._batch_tables(shuffled, batch_size)
                train_m = self.run_epoch(params, buffers, opt, cache,
                                         idx_tab, mask_tab, train=True,
                                         lr_factor=lr_factor, active=active)
                val_m = self.run_epoch(params, buffers, None, cache, v_idx,
                                       v_mask, train=False)
                val_loss = np.array([m["loss"] for m in val_m])
                val_auc = np.array([m["auc"] for m in val_m])
                improved = val_loss < best_val
                if best is None:
                    best = {"params": {k: v.detach().clone()
                                       for k, v in params.items()},
                            "buffers": {k: v.clone()
                                        for k, v in buffers.items()}}
                else:
                    imp = torch.as_tensor(improved[self.trials]).to(
                        self.device)
                    for part, cur in (("params", params),
                                      ("buffers", buffers)):
                        for k, v in cur.items():
                            keep = imp.view((-1,) + (1,) * (v.ndim - 1))
                            best[part][k] = torch.where(keep, v.detach(),
                                                        best[part][k])
                best_val = np.where(improved, val_loss, best_val)
                wait = np.where(improved, 0, wait + 1)
                plateau_improved = val_loss < best_plateau - 1e-4
                best_plateau = np.where(plateau_improved, val_loss,
                                        best_plateau)
                plateau_wait = np.where(plateau_improved, 0,
                                        plateau_wait + 1)
                reduce = plateau_wait >= plateau_patience
                # Keras min_lr 1e-8 is absolute; the factor multiplies the
                # phase's rate.
                min_factor = 1e-8 / max(float(phase.lr), 1e-30)
                lr_factor = np.where(reduce,
                                     np.maximum(lr_factor * 0.5, min_factor),
                                     lr_factor).astype(np.float32)
                plateau_wait = np.where(reduce, 0, plateau_wait)
                active = (wait < patience).astype(np.float32)

                history.append({
                    "epoch": epoch, "phase": phase.name,
                    "train_loss": np.array([m["loss"] for m in train_m]),
                    "train_auc": np.array([m["auc"] for m in train_m]),
                    "val_loss": val_loss, "val_auc": val_auc,
                    "active": active.copy(),
                    "seconds": time.time() - t0})
                if verbose and mesh_lib.is_main():
                    print(f"[{self.progress_label} x{f}|{phase.name}] "
                          f"epoch {epoch}: "
                          f"val_loss={np.round(val_loss, 3)} "
                          f"val_auc={np.round(val_auc, 3)} "
                          f"active={int(active.sum())} "
                          f"({history[-1]['seconds']:.1f}s)", flush=True)
                stopped = bool(active.sum() == 0)
                if checkpoint_dir:
                    self._save_resume(
                        checkpoint_dir, params, buffers, opt, best,
                        {"epoch": epoch, "phase_idx": phase_idx,
                         "epoch_in_phase": int(epoch_in_phase),
                         "history": self._history_to_host(history),
                         "lr_factor": [float(v) for v in lr_factor],
                         "active": [float(v) for v in active],
                         "best_val": [float(v) for v in best_val],
                         "best_plateau": [float(v) for v in best_plateau],
                         "wait": [int(v) for v in wait],
                         "plateau_wait": [int(v) for v in plateau_wait],
                         "phase_done": stopped})
                epoch += 1
                epoch_in_phase += 1
                if stopped:
                    break

            carry = self._end_vars(params, buffers, best, wait, patience)

        self.epoch_programs.clear()  # the graphs and their memory
        if carry is None:
            raise ValueError("the phase plan ran no epoch (EPOCHS 0?)")
        return self._gather_trials({"params": carry[0],
                                    "buffers": carry[1]}), history

    def _save_resume(self, path: str, params, buffers, opt, best,
                     progress: Dict) -> None:
        """The whole stacked state (parameters, buffers, optimizer moments
        and step counts, best weights, the step index), gathered to all F
        trials (every rank joins), and the host progress as one atomic
        file (``utils/resume.py``: rank 0 writes)."""
        sd = opt.state_dict()
        sd["count"] = sd["count"].to(self.device)
        payload = self._gather_trials(
            {"params": {k: v.detach() for k, v in params.items()},
             "buffers": buffers, "optimizer": sd, "best": best})
        payload["optimizer"]["count"] = payload["optimizer"]["count"].cpu()
        save_resume(path, self.RESUME_FILE, {**payload, "step": self.step},
                    progress)

    def _restore(self, payload, params, buffers, opt) -> None:
        """This rank's trials of a checkpoint of all F."""
        t = self.trials
        with torch.no_grad():
            for part, cur in (("params", params), ("buffers", buffers)):
                for k, v in cur.items():
                    v.copy_(payload[part][k][t])
        sd = payload["optimizer"]
        opt.load_state_dict({
            "count": sd["count"][t],
            "state": {n: {k: v[t] for k, v in slots.items()}
                      for n, slots in sd["state"].items()}})
        self.step = int(payload["step"])

    def _end_vars(self, params, buffers, best, wait, patience
                  ) -> Tuple[Stacked, Stacked]:
        """Each trial's end-of-phase weights, Keras semantics: the best
        validation weights only for trials whose patience ran out (Keras
        EarlyStopping restores inside its stop branch); the others keep
        their final weights, as the serial ``Trainer`` does."""
        if best is None:
            return params, buffers
        early = torch.as_tensor(
            (np.asarray(wait) >= patience)[self.trials]).to(self.device)
        with torch.no_grad():
            for part, cur in (("params", params), ("buffers", buffers)):
                for k, v in cur.items():
                    keep = early.view((-1,) + (1,) * (v.ndim - 1))
                    v.copy_(torch.where(keep, best[part][k], v))
        return params, buffers
