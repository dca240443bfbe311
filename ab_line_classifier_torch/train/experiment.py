"""Experiment orchestration (port of the ``single_train`` part of the JAX
package's ``train/experiment.py``): resolve the data, class weights and
output bias, build the model, fit it through its phase plan, save a port
checkpoint (``state.pt`` + ``meta.json``, which the predict CLI serves),
and evaluate on the test set.

``cross_validation``, ``hparam_search`` and the trial-parallel variants
raise ``NotImplementedError``: they come with later slices of the port
(ROADMAP Queue A items 13-14). pandas is imported only where tables are
read.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.config import Config, ensure_output_dirs
from ab_line_classifier_torch.data import splits as S
from ab_line_classifier_torch.data.pipeline import (FrameDataset,
                                                    device_cache_budget,
                                                    maybe_device_cache)
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec, compute_dtype
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.train.class_balance import (
    compute_class_weight, compute_output_bias)
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.train.tracker import make_tracker
from ab_line_classifier_torch.utils import checkpoint as ckpt

_LATER = ("waits for a later slice of the port (ROADMAP Queue A items "
          "13-14)")


@dataclasses.dataclass
class RunResult:
    test_metrics: Dict[str, Any]
    history: List
    model_dir: Optional[str]
    best_val: Dict[str, float]


def load_pretrained_state(path: str, spec: ModelSpec, seed: int = 0,
                          verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Warm-start weights (``USE_PRETRAINED`` + ``PATHS.PRETRAINED_WEIGHTS``):
    a Keras ``.h5`` imported by layer name over the trainer's own seeded
    initialization (layers the file lacks keep it; a file that matches no
    layer raises), or a port checkpoint directory."""
    if path.endswith(".h5"):
        from ab_line_classifier_torch.models.weights import import_h5_state

        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Could not find pretrained weights at: {path!r} "
                f"(PATHS.PRETRAINED_WEIGHTS with TRAIN.USE_PRETRAINED set)")
        base = spec.logits_module(
            generator=torch.Generator().manual_seed(seed)).state_dict()
        state, copied = import_h5_state(path, base, graph=spec.graph,
                                        verbose=verbose)
        if copied == 0:
            raise ValueError(f"no layers matched while importing pretrained "
                             f"weights {path!r}: wrong TRAIN.MODEL_DEF?")
        if verbose:
            print(f"warm start: {copied} layers from {path}")
        return state
    state, _ = ckpt.load_model(path)
    return state


def configured_cache_budget(cfg: Config, device) -> int:
    """The device cache's budget (half the device's free memory), capped at
    ``TRAIN.MEMORY_LIMIT`` MB when ``TRAIN.USE_MEMORY_LIMIT`` is set."""
    budget = device_cache_budget(device)
    if cfg["TRAIN"].get("USE_MEMORY_LIMIT", False):
        budget = min(budget, int(cfg["TRAIN"]["MEMORY_LIMIT"]) << 20)
    return budget


def _cache_mode(cfg: Config):
    mode = cfg["TRAIN"].get("CACHE_DATASET", "auto")
    if isinstance(mode, str):
        valid = {"auto": "auto", "true": True, "false": False, "on": True,
                 "off": False}
        if mode.lower() not in valid:
            raise ValueError(f"TRAIN.CACHE_DATASET {mode!r} is not one of "
                             f"auto/true/false")
        mode = valid[mode.lower()]
    return mode


def _store_has_train_val_test(cfg: Config) -> bool:
    """Whether the local artifact store (``TRACKER.ARTIFACTS_DIR``) holds a
    committed TrainValTest version (a ``v<N>`` directory with its
    ``metadata.json``)."""
    root = os.path.join((cfg.get("TRACKER") or {}).get(
        "ARTIFACTS_DIR", "results/artifacts/"), "TrainValTest")
    return os.path.isdir(root) and any(
        d.startswith("v") and d[1:].isdigit()
        and os.path.isfile(os.path.join(root, d, "metadata.json"))
        for d in os.listdir(root))


def resolve_datasets(cfg: Config) -> Tuple[Any, Any, Any, str]:
    """``(train_df, val_df, test_df, frames_dir)`` by the JAX package's
    resolution order, first match wins:

    1. a pinned W&B artifact version (``WANDB.TRAIN_VAL_TEST_ARTIFACT_
       VERSION``): raises ``NotImplementedError``;
    2. partition CSVs under ``PATHS.PARTITIONS``/frames;
    3. the local artifact store's TrainValTest artifact: raises
       ``NotImplementedError``;
    4. a patient-grouped split of ``PATHS.FRAME_TABLE`` with
       ``WANDB.ARTIFACT_SEED``.

    Sources 1 and 3 wait for the artifact slice of the port; falling
    through them would train on another split than the JAX package's."""
    import pandas as pd

    paths = cfg["PATHS"]
    frames_dir = paths["FRAMES"]
    wandb = cfg.get("WANDB") or {}
    if str(wandb.get("TRAIN_VAL_TEST_ARTIFACT_VERSION", "") or ""):
        raise NotImplementedError(
            f"WANDB.TRAIN_VAL_TEST_ARTIFACT_VERSION pins a W&B artifact: "
            f"fetching it {_LATER}")
    part_frames = os.path.join(paths.get("PARTITIONS", ""), "frames")
    if os.path.isfile(os.path.join(part_frames, "train.csv")):
        return tuple(pd.read_csv(os.path.join(part_frames, f"{s}.csv"))
                     for s in ("train", "val", "test")) + (frames_dir,)
    if _store_has_train_val_test(cfg):
        raise NotImplementedError(
            f"the local artifact store holds a TrainValTest artifact: "
            f"reading it {_LATER}")
    train_df, val_df, test_df = S.train_val_test_split(
        pd.read_csv(paths["FRAME_TABLE"]), float(cfg["DATA"]["VAL_SPLIT"]),
        float(cfg["DATA"]["TEST_SPLIT"]),
        random_seed=int(wandb.get("ARTIFACT_SEED", 42)))
    return train_df, val_df, test_df, frames_dir


def generate_classification_test_results(predictor: Predictor, test_df,
                                         frames_dir: str, cfg: Config,
                                         tracker=None) -> Dict[str, Any]:
    """Test-set evaluation with exact (sklearn) metrics, logged through the
    tracker. The ROC and confusion-matrix figures wait for the plots of
    ``viz/visualization.py``."""
    from ab_line_classifier_torch.predict.metrics import compute_metrics

    probs = predictor.predict_dataset(
        FrameDataset(test_df, frames_dir, img_dim=cfg.img_dim))
    labels = test_df["Class"].to_numpy()
    preds = (probs[:, 1] >= 0.5).astype(int)
    metrics = compute_metrics(cfg.classes, labels, preds, probs)
    if tracker is not None:
        tracker.log_metrics("test", metrics)
    return metrics


def perform_single_run(cfg: Config, *, save_weights: bool = False,
                       tracker=None, verbose: bool = True,
                       checkpoint_dir: Optional[str] = None,
                       resume: bool = False, device=None) -> RunResult:
    """One training run: data -> class weights and output bias -> model ->
    fit through the phase plan -> checkpoint -> test-set evaluation. A
    tracker made here is closed here, as failed when the run raises."""
    if tracker is not None:
        return _perform_single_run_body(
            cfg, tracker, save_weights=save_weights, verbose=verbose,
            checkpoint_dir=checkpoint_dir, resume=resume, device=device,
            finish_tracker=False)
    tracker = make_tracker(cfg, job_type=cfg["TRAIN"]["EXPERIMENT_TYPE"])
    try:
        return _perform_single_run_body(
            cfg, tracker, save_weights=save_weights, verbose=verbose,
            checkpoint_dir=checkpoint_dir, resume=resume, device=device,
            finish_tracker=True)
    except BaseException as e:
        # A crashed run still closes its run directory; a finish that
        # fails itself must not hide the error.
        try:
            tracker.finish({"status": "failed",
                            "error": f"{type(e).__name__}: {e}"})
        except Exception as fin_err:
            print(f"(tracker.finish failed on crashed run: {fin_err})")
        raise


def _perform_single_run_body(cfg: Config, tracker, *, save_weights, verbose,
                             checkpoint_dir, resume, device,
                             finish_tracker) -> RunResult:
    device = resolve_device(device)
    ensure_output_dirs(cfg)
    model_name = cfg.model_name
    hparams = cfg.model_hparams()
    tracker.log_config({"HPARAMS": hparams, "TRAIN": dict(cfg["TRAIN"]),
                        "DATA": {"IMG_DIM": list(cfg.img_dim)},
                        "FOLD_ID": None})

    train_df, val_df, test_df, frames_dir = resolve_datasets(cfg)
    mixed = bool(cfg["TRAIN"].get("MIXED_PRECISION", False))
    dtype = compute_dtype(mixed)
    seed = int(cfg["TRAIN"]["SEED"])
    spec = build_model(model_name, hparams, cfg.img_dim + (3,),
                       cfg.n_classes, mixed_precision=mixed,
                       output_bias=compute_output_bias(train_df),
                       total_epochs=int(cfg["TRAIN"]["EPOCHS"]))
    pretrained = None
    if cfg["TRAIN"].get("USE_PRETRAINED", False):
        pretrained = load_pretrained_state(
            cfg["PATHS"]["PRETRAINED_WEIGHTS"], spec, seed, verbose)

    trainer = Trainer(spec, class_weight=compute_class_weight(train_df),
                      class_names=cfg.classes,
                      aug_config=dict(cfg["TRAIN"]["DATA_AUG"]), seed=seed,
                      compute_dtype=dtype, device=device)
    train_ds = FrameDataset(train_df, frames_dir, img_dim=cfg.img_dim)
    val_ds = FrameDataset(val_df, frames_dir, img_dim=cfg.img_dim)
    # One budget for the pair, split by their sizes.
    mode = _cache_mode(cfg)
    budget = configured_cache_budget(cfg, device)
    frac = len(train_ds) / max(len(train_ds) + len(val_ds), 1)
    train_ds = maybe_device_cache(train_ds, mode, device=device,
                                  budget=int(budget * frac))
    val_ds = maybe_device_cache(val_ds, mode, device=device,
                                budget=int(budget * (1 - frac)))

    from ab_line_classifier_torch.train.callbacks import (
        PredictionTableLogger)
    callbacks = [PredictionTableLogger(spec, val_ds, tracker=tracker,
                                       compute_dtype=dtype, device=device)]
    best, history = trainer.fit(
        train_ds, val_ds, batch_size=cfg.batch_size,
        epochs=int(cfg["TRAIN"]["EPOCHS"]),
        patience=int(cfg["TRAIN"]["PATIENCE"]), variables=pretrained,
        tracker=tracker, verbose=verbose, callbacks=callbacks,
        checkpoint_dir=checkpoint_dir, resume=resume)

    model_dir = None
    if save_weights:
        model_dir = os.path.join(cfg["PATHS"]["MODEL_WEIGHTS"],
                                 f"model{time.strftime('%Y%m%d-%H%M%S')}")
        ckpt.save_model(model_dir, best, meta={
            "model_name": model_name, "hparams": hparams,
            "input_shape": list(cfg.img_dim) + [3],
            "n_classes": cfg.n_classes, "classes": cfg.classes,
            "preprocess_mode": spec.preprocess_mode,
            "mixed_precision": mixed})

    test_metrics: Dict[str, Any] = {}
    if test_df is not None and len(test_df):
        predictor = Predictor(spec, best, batch_size=cfg.batch_size,
                              compute_dtype=dtype, device=device)
        test_metrics = generate_classification_test_results(
            predictor, test_df, frames_dir, cfg, tracker)

    best_val: Dict[str, float] = {}
    with_val = [h for h in history if h.val]
    if with_val:
        best_log = min(with_val, key=lambda h: h.val["loss"])
        best_val = {f"val_{k}": v for k, v in best_log.val.items()}
    if finish_tracker:
        tracker.finish({**{f"test/{k}": v for k, v in test_metrics.items()
                           if not isinstance(v, list)}, **best_val})
    return RunResult(test_metrics=test_metrics, history=history,
                     model_dir=model_dir, best_val=best_val)


def default_checkpoint_dir(cfg: Config, experiment: str) -> str:
    """Where per-epoch resume checkpoints live when ``--resume`` names no
    ``--checkpoint-dir``."""
    return os.path.join(cfg["PATHS"]["MODEL_WEIGHTS"], "_resume", experiment)


def train_experiment(cfg: Config, experiment: Optional[str] = None,
                     save_weights: bool = False, verbose: bool = True,
                     trial_parallel: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     resume: bool = False, device=None) -> RunResult:
    """Run ``TRAIN.EXPERIMENT_TYPE`` (or ``experiment``) on ``device``
    (``cuda`` unless asked for the CPU; raises at once without a GPU)."""
    device = resolve_device(device)
    experiment = experiment or cfg["TRAIN"]["EXPERIMENT_TYPE"]
    if trial_parallel:
        raise NotImplementedError(f"--trial-parallel {_LATER}")
    if experiment in ("cross_validation", "hparam_search"):
        raise NotImplementedError(f"experiment {experiment!r} {_LATER}")
    if experiment != "single_train":
        raise ValueError(
            "Invalid entry in TRAIN > EXPERIMENT_TYPE field of config.yml.")
    if resume and checkpoint_dir is None:
        checkpoint_dir = default_checkpoint_dir(cfg, experiment)
    return perform_single_run(cfg, save_weights=save_weights,
                              verbose=verbose, checkpoint_dir=checkpoint_dir,
                              resume=resume, device=device)
