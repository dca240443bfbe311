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
(``graph.set_compute_dtype``). The JAX package scans whole epochs as one
program, a TPU dispatch workaround; the port runs the step eagerly.
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
from ab_line_classifier_torch.models.common import (
    ModelSpec, TrainPhase, get_learning_rate, make_optimizer,
    scale_learning_rate)
from ab_line_classifier_torch.models.preprocess import get_preprocess_fn
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.train import objective
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
    states = np.random.SeedSequence([seed, phase_idx, step]).generate_state(
        2, np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(int(s))
                 for s in states)


def _copy_state(module: torch.nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


class Trainer:
    """Drives a :class:`ModelSpec` through its phase plan on one device
    (``cuda`` unless ``device`` says otherwise).

    ``compute_dtype`` bfloat16 trains mixed precision (float32 parameters).
    ``seed`` seeds the fresh module and every step's generators.
    """

    RESUME_FILE = "train_state.pt"

    def __init__(self, spec: ModelSpec, *,
                 class_weight: Optional[Dict[int, float]] = None,
                 class_names: Optional[List[str]] = None,
                 aug_config: Optional[Dict] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
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
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.phase_idx = 0
        self.step = 0

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

    def state(self) -> StateDict:
        """The module's state dict, copied to the CPU."""
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.module.state_dict().items()}

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, metrics: M.MetricsState
                   ) -> torch.Tensor:
        """One step on a uint8 ``[B, H, W, 3]`` batch on the device (labels
        ``[B]``, mask ``[B]``): augment, forward, loss, backward, update;
        accumulates ``metrics``. Returns the loss (on the device)."""
        self.module.train()
        gen_aug, gen_drop = step_generators(self.seed, self.phase_idx,
                                            self.step, self.device)
        labels_oh = M.one_hot(labels, self.spec.n_classes)
        x = objective.prepare_images(self.preprocess_fn, self.aug_params,
                                     self.compute_dtype, images, gen_aug)
        loss, probs, per_ex = objective.forward_loss(
            self.module, self.reg_layers, self.reg_lambdas, x, labels_oh,
            mask, self.class_weight, train=True, generator=gen_drop)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
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
        """One epoch of ``dataset`` (a device cache: gathers on the device;
        a :class:`FrameDataset`: host batches copied over), shuffled by
        ``shuffle_seed`` when training. Returns the epoch's metrics."""
        metrics = M.init_metrics(self.spec.n_classes, device=self.device)
        step = self.train_step if train else self.eval_step
        for batch in dataset.batches(batch_size, shuffle=train,
                                     seed=shuffle_seed):
            step(*(torch.as_tensor(a, device=self.device)
                   for a in (batch.images, batch.labels, batch.mask)),
                 metrics)
        return M.compute_metrics(metrics, self.class_names)

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
                if verbose:
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
                        if verbose:
                            print(f"  ReduceLROnPlateau: lr -> {new_lr:.2e}")
                    if stopped and verbose:
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
        return self.state(), history
