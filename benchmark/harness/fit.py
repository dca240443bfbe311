"""The fit driver: one cross-validation fold trained on a device-cached
set, ``Trainer.run_epoch`` over the training set then over the validation
set, epoch after epoch.

Set-up: the seeded weights and sets; the trainer in the configuration's
phase from those weights; a training epoch on the window's set, whose
first ``check_steps`` steps (the program's eager step, its capture and a
replay) are read; a validation epoch (its eager step and capture). Window:
epochs of training and validation until ``seconds`` have passed; the rate
is the training frames over the host seconds, validation and each epoch's
readback included. After the window and the peak memory are read: a check
epoch of training and of validation through the same programs, its first
training steps read as in set-up and every validated frame's logits kept.
The trainer is then dropped, and the reference follows the set-up's read
steps from the seeded weights, the check epoch's from the program's
parameters and optimizer state before it, and the validation from the
program's parameters after it.

The steps are read from outside the program, in set-up and the check epoch
alone: after each call of the trainer's training or evaluation step
(``StepGraph.__call__`` wrapped) the harness reads the epoch's metrics
(the step's loss) and the parameters; an evaluation step's logits are the tensor its module's
forward returned when the step ran or was captured (a forward hook), which
each replay writes again."""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

import reference
from reference import augment as ref_aug
from reference import serve as ref_serve
from reference import train as ref_train

from harness import check, gen, weights
from harness import trace as T
from harness import work as W
from harness.outcome import (Outcome, View, launch_note, memory_peak,
                             release, set_up, sync)


class _Frames:
    """What ``DeviceCachedDataset``'s constructor reads: frames already on
    the device, host labels."""

    def __init__(self, images: torch.Tensor, labels: np.ndarray):
        self.images, self.labels = images, labels
        self.img_dim = tuple(images.shape[1:3])
        self.frame_paths = None

    def load_all(self):
        return self.images, self.labels


def class_weight(labels: np.ndarray, n_classes: int) -> dict:
    """Balanced class weights, ``total / (n_classes * count)``."""
    counts = np.bincount(labels, minlength=n_classes)
    return {i: float(len(labels) / (n_classes * max(c, 1)))
            for i, c in enumerate(counts)}


def _trained(trainer):
    return [(n, p) for n, p in trainer.module.named_parameters()
            if p.requires_grad]


def trainable(trainer) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in _trained(trainer)}


def optimizer_slots(trainer, kind: str):
    """Each trainable leaf's optimizer state in the reference's layout
    (``reference.train.Optimizer``), and the steps taken."""
    slots, t = {}, 0
    for name, p in _trained(trainer):
        st = trainer.optimizer.state[p]
        slots[name] = ([st["square_avg"].detach().clone(),
                        torch.zeros_like(p)] if kind == "rmsprop" else
                       [st["m"].detach().clone(), st["v"].detach().clone()])
        t = int(st["step"])
    return slots, t


@contextlib.contextmanager
def watching(trainer, on_train=None, on_eval=None):
    """Inside: after the k-th call (from 1) of the trainer's training or
    evaluation program's step, ``on_train(k, program)`` or ``on_eval(k,
    program)``."""
    from ab_line_classifier_torch.train import graphed

    call = graphed.StepGraph.__call__
    seen = {"train": 0, "eval": 0}

    def watched(step):
        call(step)
        for key, hook in (("train", on_train), ("eval", on_eval)):
            prog = trainer.epoch_programs.get(key)
            if hook is not None and prog is not None and prog.step is step:
                seen[key] += 1
                hook(seen[key], prog)

    graphed.StepGraph.__call__ = watched
    try:
        yield
    finally:
        graphed.StepGraph.__call__ = call


class StepRecord:
    """The first ``steps`` training steps of an epoch as the program took
    them: each step's loss (the epoch's loss sum over its count, step by
    step) and the trainable parameters after the last."""

    def __init__(self, trainer, steps: int):
        self.trainer, self.steps = trainer, steps
        self.losses, self.params = [], None
        self._sum = self._n = 0.0

    def __call__(self, k: int, prog) -> None:
        if k > self.steps:
            return
        s, n = float(prog.metrics.loss_sum), float(prog.metrics.n)
        self.losses.append((s - self._sum) / (n - self._n))
        self._sum, self._n = s, n
        if k == self.steps:
            self.params = trainable(self.trainer)

    def record(self) -> dict:
        if self.params is None:
            raise RuntimeError(f"{len(self.losses)} training steps read of "
                               f"{self.steps}: the epoch did not step "
                               f"through the trainer's program")
        return {"losses": self.losses, "params": self.params}


class Logits:
    """Every validated frame's logits of an epoch, in its order: the
    evaluation step's module output, kept while ``kept_from`` is on (the
    tensor of the eager run, then the capture's, which replays write
    again), copied out after each step by :meth:`copy`."""

    def __init__(self, rows: int, n_classes: int, device):
        self.out = torch.empty((rows, n_classes), dtype=torch.float32,
                               device=device)
        self.kept: Optional[torch.Tensor] = None

    @contextlib.contextmanager
    def kept_from(self, module):
        def hook(m, args, out):
            if not m.training:
                self.kept = out[0] if isinstance(out, tuple) else out

        handle = module.register_forward_hook(hook)
        try:
            yield
        finally:
            handle.remove()

    def copy(self, k: int, prog) -> None:
        b = self.kept.shape[0]
        self.out[(k - 1) * b:k * b].copy_(self.kept)


def inputs(ref, cfg: dict, tr: dict, seed: int, device) -> dict:
    """A fit run's inputs from its seed: the weights, the training and
    validation sets, the class weights and the trainer's seed."""
    tx, ty, vx, vy = gen.fit_sets(seed, tr, device)
    return {"state": weights.make(ref, cfg, seed, device),
            "tx": tx, "ty": ty, "vx": vx, "vy": vy,
            "class_weight": class_weight(ty.cpu().numpy(),
                                         cfg["n_classes"]),
            "trainer_seed": gen.stream_seed(seed, "trainer")}


def _loaded(ref, inp: dict, params, device):
    """``ref`` on ``device`` with the run's seeded weights, the trainable
    leaves ``params`` where given."""
    ref = ref.to(device)
    ref.load_state_dict(inp["state"])
    if params:
        ref.load_state_dict(params, strict=False)
    return ref


def reference_steps(ref, cfg: dict, tr: dict, inp: dict, device, *,
                    shuffle_seed: int = 0, first_step: int = 0,
                    params=None, slots=None, t: int = 0) -> dict:
    """The reference's first ``check_steps`` steps of a training epoch
    shuffled by ``shuffle_seed``, from the seeded weights (the trainable
    leaves ``params``, the optimizer state ``slots`` and ``t`` where
    given), the first being the phase's step ``first_step``."""
    b, steps = tr["batch"], tr["check_steps"]
    ref = _loaded(ref, inp, params, device)
    cw = torch.tensor([inp["class_weight"][i]
                       for i in range(cfg["n_classes"])], device=device)
    rows = torch.as_tensor(ref_train.shuffled(len(inp["ty"]), shuffle_seed)
                           [:steps * b], device=device)
    x, y = inp["tx"][rows], inp["ty"][rows]
    with reference.exact_float32():
        return ref_train.train_steps(
            ref, cfg, ref_aug.params_from_config(tr["augmentation"]),
            inp["trainer_seed"],
            [(x[k * b:(k + 1) * b], y[k * b:(k + 1) * b])
             for k in range(steps)], cw, first_step, slots, t)


def reference_validation(ref, cfg: dict, inp: dict, device, params=None):
    """The reference's probabilities of the validation frames and each
    frame's logit scale (``reference.serve.probabilities``), from the
    seeded weights, the trainable leaves ``params`` where given."""
    ref = _loaded(ref, inp, params, device)
    with reference.exact_float32():
        return ref_serve.probabilities(ref, cfg, inp["vx"])


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import launches
    from ab_line_classifier_torch.train.loop import Trainer

    cfg, tr = cell.config, cell.traffic
    marks = [("imports", time.perf_counter() - t_start)]
    ph, b, steps = cfg["train_phase"], tr["batch"], tr["check_steps"]
    kind = ph["optimizer"]
    ref = reference.build(cfg)
    inp = inputs(ref, cfg, tr, seed, device)
    sync(device)
    marks.append(("weights and sets", time.perf_counter() - t_start))
    spec = build_model(cfg["model_def"], cfg["hparams"],
                       tuple(cfg["input_shape"]), cfg["n_classes"],
                       mixed_precision=cfg["mixed_precision"])
    phase = spec.phases[ph["index"]]
    if phase.name != ph["name"]:
        raise ValueError(f"phase {ph['index']} of {cfg['model_def']} is "
                         f"{phase.name!r}, not {ph['name']!r}")
    trainer = Trainer(spec, class_weight=inp["class_weight"],
                      class_names=cfg["classes"],
                      aug_config=tr["augmentation"], seed=inp["trainer_seed"],
                      compute_dtype=(torch.bfloat16 if cfg["mixed_precision"]
                                     else torch.float32), device=device)
    trainer.begin_phase(ph["index"], phase, variables=inp["state"])
    train_ds = DeviceCachedDataset(
        _Frames(inp["tx"], inp["ty"].cpu().numpy()), device)
    val_ds = DeviceCachedDataset(
        _Frames(inp["vx"], inp["vy"].cpu().numpy()), device)
    marks.append(("trainer", time.perf_counter() - t_start))

    first = StepRecord(trainer, steps)
    with watching(trainer, on_train=first):
        trainer.run_epoch(train_ds, b, train=True, shuffle_seed=0)
    sync(device)
    marks.append(("training epoch", time.perf_counter() - t_start))
    logits = Logits(val_ds.n_batches(b) * b, cfg["n_classes"], device)
    with logits.kept_from(trainer.module):
        trainer.run_epoch(val_ds, b, train=False)
    sync(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("validation epoch", setup_s))

    epochs, bad = 0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while epochs == 0 or time.perf_counter() < deadline:
        m = trainer.run_epoch(train_ds, b, train=True,
                              shuffle_seed=1 + epochs)
        v = trainer.run_epoch(val_ds, b, train=False)
        bad += not (math.isfinite(m["loss"]) and math.isfinite(v["loss"]))
        epochs += 1
    window_s = time.perf_counter() - t0
    e2e = {"setup_s": setup_s,
           "fit_frames_per_s": epochs * len(train_ds) / window_s}
    shuffle_seed = 1 + epochs

    view, notes = View("fit"), [set_up(marks)]
    if traced:
        before = launches.counts()
        with T.recording(device) as rec:
            sync(device)
            with T.window():
                trainer.run_epoch(train_ds, b, train=True,
                                  shuffle_seed=shuffle_seed)
                trainer.run_epoch(val_ds, b, train=False)
                sync(device)
        shuffle_seed += 1
        view.trace = rec["reduction"]
        view.frames, view.val_frames = len(train_ds), len(val_ds)
        notes += launch_note(before, launches.counts(), view.trace,
                             cell.per_layer)
    peak = memory_peak(device)

    slots, t = optimizer_slots(trainer, kind)
    late_from = {"params": trainable(trainer), "slots": slots, "t": t,
                 "first_step": trainer.step, "shuffle_seed": shuffle_seed}
    late = StepRecord(trainer, steps)
    with watching(trainer, on_train=late, on_eval=logits.copy):
        trainer.run_epoch(train_ds, b, train=True, shuffle_seed=shuffle_seed)
        final = trainable(trainer)
        with logits.kept_from(trainer.module):
            trainer.run_epoch(val_ds, b, train=False)
    served = torch.softmax(logits.out[:len(val_ds)], dim=-1)
    records = {"set-up": first.record(), "check epoch": late.record()}
    trainer.release_programs()
    del trainer, train_ds, val_ds, logits
    release(device)

    view.work = W.cell_work(ref, cfg, tr)
    want = {"set-up": reference_steps(ref, cfg, tr, inp, device),
            "check epoch": reference_steps(ref, cfg, tr, inp, device,
                                           **late_from)}
    starts = {"set-up": inp["state"], "check epoch": late_from["params"]}
    numbers = check.fit_numbers(records, want, starts, notes)
    gaps = check.AnswerGap()
    gaps.add([served], *reference_validation(ref, cfg, inp, device, final))
    numbers["val_logit_gap"] = gaps.logit_gap()
    notes.append(f"compared {gaps.rows} validated frames' logits")
    return Outcome(e2e, epochs * len(inp["tx"]) // b, bad, numbers, view,
                   peak, notes)
