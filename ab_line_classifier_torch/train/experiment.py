"""Experiment orchestration (port of the JAX package's
``train/experiment.py``): ``single_train``, serial ``cross_validation``
and serial ``hparam_search``.

A run resolves its data, class weights and output bias, builds the model
(config hyperparameters, overridden by a sweep's), fits it through its
phase plan, saves a port checkpoint (``state.pt`` + ``meta.json``, which
the predict CLI serves) and evaluates on the test set. Cross-validation
runs one such run per fold, hyperparameter search one per trial, with the
JAX package's folds, trials, records on disk and resume.

Every run trains from a :class:`FoldSource`: one frame table (a
:class:`FrameDataset` decoded from its JPEGs as it is used, or
:class:`FrameArrays` already decoded) and a
:class:`~ab_line_classifier_torch.data.splits.FoldSet` of row indices per
fold; a train/val/test split is a one-fold set. A run takes its fold's
rows and caches its train and val sets on the device by the JAX
package's rule (one budget for the pair, per run), else streams them.
:class:`FrameArrays` is the seam through which cross-validation and sweeps
run where pandas, PIL and sklearn are not installed: the loop, records,
resume, controllers and summaries are numeric and written with ``json``
and ``csv``. pandas is imported only where tables are read.

The trial-parallel variants (:func:`lr_search_parallel`,
:func:`cross_validation_parallel`) train every LR trial or every fold at
once, one stacked model (``parallel/trial_parallel.py::
ParallelFoldTrainer``), from the union of their rows held once on the
device.

Under a process group (``torchrun``, one process per device) every
experiment takes the mesh of ``PARALLEL.MESH`` (``parallel/mesh.py::
mesh_from_config``): a run's steps are data-parallel over its ``data``
axis, its caches split over it where one device's budget is too small,
its test set served over every rank; the trial-parallel trainer shards
its trials over the ``trial`` axis. Every rank runs the same control
flow, and rank 0 alone writes checkpoints, records, CSVs, plots and
tracker logs (the others get a ``NullTracker``). A pinned W&B
artifact version is fetched into the local store
(``data/wandb_artifacts.py``), and ``TRAIN.HPARAM_SEARCH.BACKEND: wandb``
lets the W&B sweep agent schedule the trials (``train/wandb_sweep.py``);
both import wandb only then.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.config import Config, ensure_output_dirs
from ab_line_classifier_torch.data import splits as S
from ab_line_classifier_torch.data.artifacts import (K_FOLD, TRAIN_VAL_TEST,
                                                     store_from_config)
from ab_line_classifier_torch.data.pipeline import (
    DeviceCachedDataset, FrameDataset, ShardedDeviceCachedDataset,
    device_cache_budget, maybe_device_cache)
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec, compute_dtype
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.predict.metrics import compute_metrics
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.train.class_balance import (
    class_weight_array, compute_class_weight, compute_output_bias,
    output_bias_array)
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.train.sweep import (SweepExhausted,
                                                  make_controller,
                                                  replay_trials,
                                                  space_from_config)
from ab_line_classifier_torch.train.tracker import make_tracker
from ab_line_classifier_torch.utils import checkpoint as ckpt
from ab_line_classifier_torch.utils.tables import write_csv

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


@dataclasses.dataclass
class FoldSource:
    """One frame table and its fold set: what every run trains from.
    ``frames`` is a :class:`FrameDataset` (decoded from disk as it is
    used) or :class:`FrameArrays` (decoded already, in host memory); a
    fold's train, val and test sets are its rows (:meth:`fold`)."""

    frames: Any
    folds: S.FoldSet

    def fold(self, fold_id: int):
        """Fold ``fold_id``'s ``(train, val, test)`` sets of frames."""
        return tuple(self.frames.take(rows)
                     for rows in self.folds.fold(fold_id))


def source_from_kfold_tables(cfg: Config, kfold_tables=None) -> FoldSource:
    """The k-fold source (:func:`resolve_kfold_tables`, or the tables
    given) as a :class:`FoldSource`."""
    folds, val_split, seed, frames_dir = (kfold_tables or
                                          resolve_kfold_tables(cfg))
    table, fold_set = S.fold_set_from_tables(folds, val_split, seed)
    return FoldSource(FrameDataset(table, frames_dir, cfg.img_dim), fold_set)


def source_from_datasets(cfg: Config) -> FoldSource:
    """:func:`resolve_datasets`' split as a one-fold :class:`FoldSource`."""
    train_df, val_df, test_df, frames_dir = resolve_datasets(cfg)
    table, fold_set = S.fold_set_from_split(train_df, val_df, test_df)
    return FoldSource(FrameDataset(table, frames_dir, cfg.img_dim), fold_set)


def _wandb_prefix(cfg: Config) -> str:
    """``entity/project``, ``project`` alone when ENTITY is blank (the API's
    default entity then applies), or empty when neither is set."""
    entity = str(cfg["WANDB"].get("ENTITY", "") or "")
    project = str(cfg["WANDB"].get("PROJECT_NAME", "") or "")
    return f"{entity}/{project}" if entity and project else project


def _pinned_version(cfg: Config, store, name: str, key: str) -> Optional[str]:
    """The local store's version of a W&B artifact pinned by
    ``WANDB.<key>``, or None when nothing is pinned (JAX
    ``train/experiment.py:311-335``). A pinned version already fetched
    into the store (``source == wandb:<name>:<ver>``) is served from it
    without touching wandb; else it is fetched through
    :class:`~ab_line_classifier_torch.data.wandb_artifacts.WandbArtifactFetcher`
    (``wandb.Api()``). Without wandb a pin raises ``ImportError``: training
    on another split than the pinned one would be silent."""
    ver = str((cfg.get("WANDB") or {}).get(key, "") or "")
    if not ver:
        return None
    if ver != "latest":  # 'latest' can move upstream: always fetched
        want = f"wandb:{name}:{ver}"
        for v in reversed(store.versions(name)):
            if store.metadata(name, v).get("source") == want:
                return v
    from ab_line_classifier_torch.data.wandb_artifacts import (
        WandbArtifactFetcher)
    try:
        fetcher = WandbArtifactFetcher(store, project=_wandb_prefix(cfg))
        path = (fetcher.fetch_k_fold(ver) if name == K_FOLD
                else fetcher.fetch_train_val_test(ver))
    except ImportError as e:
        raise ImportError(
            f"WANDB.{key} pins artifact version {ver!r} but wandb "
            f"is not importable — install wandb or clear the pin "
            f"(training on a different split than the one pinned "
            f"would be silent data corruption)") from e
    return os.path.basename(path.rstrip(os.sep))


def resolve_datasets(cfg: Config, fold_id: Optional[int] = None,
                     kfold_tables=None) -> Tuple[Any, Any, Any, str]:
    """``(train_df, val_df, test_df, frames_dir)`` by the JAX package's
    resolution order (JAX ``train/experiment.py:135-216``), first match
    wins:

    1. a pinned W&B artifact version (``WANDB.TRAIN_VAL_TEST_ARTIFACT_
       VERSION``): served from the store when it was fetched before, else
       fetched into it (:func:`_pinned_version`);
    2. partition CSVs under ``PATHS.PARTITIONS``/frames;
    3. the local artifact store's latest TrainValTest artifact;
    4. a patient-grouped split of ``PATHS.FRAME_TABLE`` with
       ``WANDB.ARTIFACT_SEED``.

    With ``fold_id``, fold ``fold_id`` of ``kfold_tables`` (default
    :func:`resolve_kfold_tables`)."""
    import pandas as pd

    paths = cfg["PATHS"]
    frames_dir = paths["FRAMES"]
    if fold_id is not None:
        folds, val_split, seed, kf_dir = (kfold_tables or
                                          resolve_kfold_tables(cfg))
        if fold_id >= len(folds):
            raise ValueError(
                f"fold_id {fold_id} out of range: the resolved fold source "
                f"has {len(folds)} folds")
        return S.fold_train_val_test(folds, fold_id, val_split,
                                     random_seed=seed) + (kf_dir,)

    store = store_from_config(cfg)
    pinned = _pinned_version(cfg, store, TRAIN_VAL_TEST,
                             "TRAIN_VAL_TEST_ARTIFACT_VERSION")
    if pinned is not None:
        tr, va, te, fdir = store.get_train_val_test_artifact(version=pinned)
        return tr, va, te, _live_dir(fdir, frames_dir)
    part_frames = os.path.join(paths.get("PARTITIONS", ""), "frames")
    if os.path.isfile(os.path.join(part_frames, "train.csv")):
        return tuple(pd.read_csv(os.path.join(part_frames, f"{s}.csv"))
                     for s in ("train", "val", "test")) + (frames_dir,)
    try:
        tr, va, te, fdir = store.get_train_val_test_artifact()
        return tr, va, te, _live_dir(fdir, frames_dir)
    except FileNotFoundError:
        pass
    train_df, val_df, test_df = S.train_val_test_split(
        pd.read_csv(paths["FRAME_TABLE"]), float(cfg["DATA"]["VAL_SPLIT"]),
        float(cfg["DATA"]["TEST_SPLIT"]),
        random_seed=int(cfg["WANDB"]["ARTIFACT_SEED"]))
    return train_df, val_df, test_df, frames_dir


def resolve_kfold_tables(cfg: Config) -> Tuple[List, float, int, str]:
    """``(folds, val_split, random_seed, frames_dir)`` by the same chain
    (JAX ``train/experiment.py:217-273``): a pinned W&B KFold version ->
    fold CSVs under ``PATHS.K_FOLDS_SPLIT_PATH`` (their ``metadata.json``
    wins over the config) -> the store's latest KFold artifact -> a
    k-fold split of ``PATHS.FRAME_TABLE``. The fold count is the source's
    own, ``TRAIN.N_FOLDS`` only that of the last."""
    import pandas as pd

    paths = cfg["PATHS"]
    frames_dir = paths["FRAMES"]
    seed = int(cfg["WANDB"]["ARTIFACT_SEED"])
    val_split = float(cfg["DATA"]["K_FOLD_VALIDATION_SPLIT"])
    store = store_from_config(cfg)

    pinned = _pinned_version(cfg, store, K_FOLD,
                             "K_FOLD_CROSS_VAL_ARTIFACT_VERSION")
    if pinned is not None:
        return _kfold_from_store(store, pinned, val_split, seed, frames_dir)
    folds_root = paths.get("K_FOLDS_SPLIT_PATH", "")
    if os.path.isfile(os.path.join(folds_root, "fold_0", "frames.csv")):
        n_folds = int(cfg["TRAIN"]["N_FOLDS"])
        meta_path = os.path.join(folds_root, "metadata.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            n_folds = int(meta.get("n_folds", n_folds))
            val_split = float(meta.get("val_split", val_split))
            seed = int(meta.get("random_seed", seed))
        folds = [pd.read_csv(os.path.join(folds_root, f"fold_{i}",
                                          "frames.csv"))
                 for i in range(n_folds)]
        return folds, val_split, seed, frames_dir
    try:
        store.resolve(K_FOLD)
    except FileNotFoundError:
        pass
    else:
        return _kfold_from_store(store, "latest", val_split, seed,
                                 frames_dir)
    folds = S.k_fold_splits(pd.read_csv(paths["FRAME_TABLE"]),
                            int(cfg["TRAIN"]["N_FOLDS"]), random_seed=seed)
    return folds, val_split, seed, frames_dir


def _kfold_from_store(store, version, default_val_split: float,
                      default_seed: int, default_frames_dir: str):
    """A store KFold artifact's fold tables and split metadata (JAX
    ``train/experiment.py:276-286``)."""
    import pandas as pd

    path = store.resolve(K_FOLD, version)
    meta = store.metadata(K_FOLD, version)
    folds = [pd.read_csv(os.path.join(path, f"fold_{i}", "frames.csv"))
             for i in range(int(meta["n_folds"]))]
    return (folds, float(meta.get("val_split", default_val_split)),
            int(meta.get("random_seed", default_seed)),
            _live_dir(meta.get("frames_dir"), default_frames_dir))


def _live_dir(fdir: Optional[str], default: str) -> str:
    """An artifact's ``frames_dir`` wins only while it exists."""
    return fdir if fdir and os.path.isdir(fdir) else default


def generate_classification_test_results(predictor: Predictor, test,
                                         cfg: Config,
                                         tracker=None) -> Dict[str, Any]:
    """Test-set evaluation (JAX ``train/experiment.py:339-371``): metrics
    (``predict/metrics.py``, numpy), logged through the tracker, and the
    ``test_roc`` / ``test_cm`` PNGs under ``PATHS.IMAGES``, logged too.
    ``test`` is a :class:`FrameDataset` or :class:`FrameArrays`. A plot
    that fails (no matplotlib) is skipped with a notice."""
    probs = predictor.predict_dataset(test)
    labels = np.asarray(test.labels)
    preds = (probs[:, 1] >= 0.5).astype(int)
    metrics = compute_metrics(cfg.classes, labels, preds, probs)
    if tracker is not None:
        tracker.log_metrics("test", metrics)
    if not mesh_lib.is_main():
        return metrics
    try:
        from ab_line_classifier_torch.viz.visualization import (
            _pyplot, plot_confusion_matrix, plot_roc)

        plt = _pyplot()
        os.makedirs(cfg["PATHS"]["IMAGES"], exist_ok=True)
        ts = time.strftime("%Y%m%d-%H%M%S")
        for fname, fig in (
                ("test_roc", plot_roc("test", labels, probs, cfg.classes)),
                ("test_cm", plot_confusion_matrix(labels, preds,
                                                  cfg.classes))):
            fig.savefig(os.path.join(cfg["PATHS"]["IMAGES"],
                                     f"{fname}_{ts}.png"), dpi=120)
            if tracker is not None:
                tracker.log_image(fname, fig)
            plt.close(fig)
    except Exception as e:  # plots never fail a run
        print(f"(plotting skipped: {e})")
    return metrics


def perform_single_run(cfg: Config, *,
                       hparam_overrides: Optional[Dict] = None,
                       fold_id: Optional[int] = None, kfold_tables=None,
                       save_weights: bool = False, tracker=None,
                       group: Optional[str] = None, verbose: bool = True,
                       checkpoint_dir: Optional[str] = None,
                       resume: bool = False, device=None) -> RunResult:
    """One training run (JAX ``train/experiment.py:372-418``): data ->
    class weights and output bias -> model (config hyperparameters updated
    by ``hparam_overrides``) -> fit through the phase plan -> checkpoint
    -> test-set evaluation. A tracker made here (in ``group``) is closed
    here, as failed when the run raises.

    :param fold_id: train on this fold of ``kfold_tables``
        (:func:`resolve_kfold_tables` by default); without it and without
        ``kfold_tables``, on :func:`resolve_datasets`' split.
    :param kfold_tables: :func:`resolve_kfold_tables`' tables, or a
        :class:`FoldSource`, whose fold ``fold_id`` (fold 0 when
        ``fold_id`` is None) is the run's split.
    """
    kw = dict(hparam_overrides=hparam_overrides, fold_id=fold_id,
              kfold_tables=kfold_tables, save_weights=save_weights,
              verbose=verbose, checkpoint_dir=checkpoint_dir, resume=resume,
              device=device)
    if tracker is not None:
        return _perform_single_run_body(cfg, tracker, finish_tracker=False,
                                        **kw)
    tracker = make_tracker(cfg, group=group,
                           job_type=cfg["TRAIN"]["EXPERIMENT_TYPE"])
    try:
        return _perform_single_run_body(cfg, tracker, finish_tracker=True,
                                        **kw)
    except BaseException as e:
        # A crashed run still closes its run directory; a finish that
        # fails itself must not hide the error.
        try:
            tracker.finish({"status": "failed",
                            "error": f"{type(e).__name__}: {e}"})
        except Exception as fin_err:
            print(f"(tracker.finish failed on crashed run: {fin_err})")
        raise


def _run_data(cfg: Config, fold_id, kfold_tables, device, mesh=None):
    """``(train_ds, val_ds, test)`` of a run: its fold of the
    :class:`FoldSource` (k-fold tables, or :func:`resolve_datasets`' split,
    become one), train and val cached on the device where they fit one
    budget for the pair, split by their sizes, or split over the mesh's
    data axis where only its ranks together hold them (JAX
    ``train/experiment.py:465-485``), else streamed."""
    if isinstance(kfold_tables, FoldSource):
        source = kfold_tables
    elif fold_id is None and kfold_tables is None:
        source = source_from_datasets(cfg)
    else:
        source = source_from_kfold_tables(cfg, kfold_tables)
    train_ds, val_ds, test = source.fold(fold_id or 0)
    mode = _cache_mode(cfg)
    budget = configured_cache_budget(cfg, device)
    frac = len(train_ds) / max(len(train_ds) + len(val_ds), 1)
    train_ds = maybe_device_cache(train_ds, mode, device=device,
                                  budget=int(budget * frac), mesh=mesh)
    val_ds = maybe_device_cache(val_ds, mode, device=device,
                                budget=int(budget * (1 - frac)), mesh=mesh)
    return train_ds, val_ds, test


def _perform_single_run_body(cfg: Config, tracker, *, hparam_overrides,
                             fold_id, kfold_tables, save_weights, verbose,
                             checkpoint_dir, resume, device,
                             finish_tracker) -> RunResult:
    device = resolve_device(device)
    ensure_output_dirs(cfg)
    model_name = cfg.model_name
    hparams = cfg.model_hparams()
    if hparam_overrides:
        hparams.update(hparam_overrides)
    tracker.log_config({"HPARAMS": hparams, "TRAIN": dict(cfg["TRAIN"]),
                        "DATA": {"IMG_DIM": list(cfg.img_dim)},
                        "FOLD_ID": fold_id})

    mesh = mesh_lib.mesh_from_config(cfg, device)
    train_ds, val_ds, test = _run_data(cfg, fold_id, kfold_tables, device,
                                       mesh)
    train_labels = train_ds.labels
    mixed = bool(cfg["TRAIN"].get("MIXED_PRECISION", False))
    dtype = compute_dtype(mixed)
    seed = int(cfg["TRAIN"]["SEED"])
    spec = build_model(model_name, hparams, cfg.img_dim + (3,),
                       cfg.n_classes, mixed_precision=mixed,
                       output_bias=compute_output_bias(train_labels),
                       total_epochs=int(cfg["TRAIN"]["EPOCHS"]))
    pretrained = None
    if cfg["TRAIN"].get("USE_PRETRAINED", False):
        pretrained = load_pretrained_state(
            cfg["PATHS"]["PRETRAINED_WEIGHTS"], spec, seed, verbose)

    trainer = Trainer(spec, class_weight=compute_class_weight(train_labels),
                      class_names=cfg.classes,
                      aug_config=dict(cfg["TRAIN"]["DATA_AUG"]), seed=seed,
                      compute_dtype=dtype, device=device, mesh=mesh)
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
    # The trained module, its optimizer state and the run's cached frames
    # go before the test set's predictor comes: serial folds and trials
    # then peak no higher.
    del trainer, callbacks, train_ds, val_ds

    model_dir = None
    if save_weights:
        model_dir = mesh_lib.broadcast_object(os.path.join(
            cfg["PATHS"]["MODEL_WEIGHTS"],
            f"model{time.strftime('%Y%m%d-%H%M%S')}"))
    if model_dir and mesh_lib.is_main():
        ckpt.save_model(model_dir, best, meta={
            "model_name": model_name, "hparams": hparams,
            "input_shape": list(cfg.img_dim) + [3],
            "n_classes": cfg.n_classes, "classes": cfg.classes,
            "preprocess_mode": spec.preprocess_mode,
            "mixed_precision": mixed})

    test_metrics: Dict[str, Any] = {}
    if test is not None and len(test):
        predictor = Predictor(spec, best, batch_size=cfg.batch_size,
                              compute_dtype=dtype, device=device, mesh=mesh)
        test_metrics = generate_classification_test_results(
            predictor, test, cfg, tracker)

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


# -- serial sweeps and cross-validation -----------------------------------
def _extract_raw_metric(result: RunResult,
                        metric_name: str) -> Optional[float]:
    """The run's raw value of a sweep metric (``epoch/val_auc`` -> the best
    epoch's val_auc; other names -> test metrics), or None."""
    key = metric_name.split("/")[-1]
    value = (result.best_val.get(key) if key.startswith("val_")
             else result.test_metrics.get(key))
    return None if value is None else float(value)


def _sweep_objective(result: RunResult, metric_name: str, goal: str) -> float:
    """The sweep objective, signed to be maximized (JAX
    ``train/experiment.py:554-572``). A metric the run lacks falls back to
    val_auc, maximized, and says so."""
    value = _extract_raw_metric(result, metric_name)
    if value is None:
        print(f"sweep: metric {metric_name!r} absent from run results "
              f"(val metrics: {sorted(result.best_val)}; test metrics: "
              f"{sorted(result.test_metrics)}); scoring this trial by "
              f"val_auc (maximize) instead")
        return float(result.best_val.get("val_auc", 0.0))
    return float(value) if goal == "maximize" else -float(value)


def _latest_trials_file(cfg: Config, prefix: str) -> Optional[str]:
    """The most recently modified ``EXPERIMENTS/{prefix}-*.jsonl``'s group
    id, or None."""
    paths = glob.glob(os.path.join(cfg["PATHS"]["EXPERIMENTS"],
                                   f"{prefix}-*.jsonl"))
    if not paths:
        return None
    latest = max(paths, key=os.path.getmtime)
    return os.path.splitext(os.path.basename(latest))[0]


def _read_trial_records(path: str, verbose: bool) -> list:
    """A ``{group}.jsonl`` trial or fold log, tolerating a torn tail (JAX
    ``train/experiment.py:588-621``): a final line cut mid-write is
    dropped and truncated off the file, so that trial reruns and appends
    at a clean line boundary; a malformed line before the last raises; an
    intact last record missing only its newline gets it back."""
    if not os.path.isfile(path):
        return []
    records = []
    with open(path, "rb") as f:
        lines = f.readlines()
    good_bytes = 0
    for i, line in enumerate(lines):
        try:
            records.append(json.loads(line))
            good_bytes += len(line)
        except json.JSONDecodeError:
            if i != len(lines) - 1:
                raise
            if verbose:
                print(f"dropping torn trailing record in {path} "
                      f"(interrupted mid-write); rerunning that trial")
            with open(path, "rb+") as f:
                f.truncate(good_bytes)
    if (lines and len(records) == len(lines)
            and not lines[-1].endswith(b"\n")):
        with open(path, "ab") as f:
            f.write(b"\n")
    return records


def _append_record(path: str, record: Dict) -> None:
    if not mesh_lib.is_main():
        return
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _records(path: str, verbose: bool) -> list:
    """Rank 0's :func:`_read_trial_records` of ``path`` on every rank (it
    alone reads, repairs and appends the file)."""
    return mesh_lib.broadcast_object(
        _read_trial_records(path, verbose) if mesh_lib.is_main() else None)


def mean_std_rows(rows: Sequence[Dict], key: str = "fold") -> List[Dict]:
    """The ``mean`` and ``std`` rows of ``rows``' numeric columns other than
    ``key``, as pandas' ``agg(["mean", "std"])`` computes them: NaN and
    missing cells skipped, the sample std (ddof 1) by its two-pass sum."""
    columns: List[str] = []
    for row in rows:
        columns += [k for k in row if k not in columns and k != key]
    mean, std = {key: "mean"}, {key: "std"}
    for c in columns:
        x = np.array([row.get(c, np.nan) for row in rows], np.float64)
        x[np.isnan(x)] = 0.0
        missing = np.array([c not in row or row[c] is None
                            or (isinstance(row[c], float)
                                and math.isnan(row[c])) for row in rows])
        n = int((~missing).sum())
        avg = x.sum(dtype=np.float64) / n if n else np.nan
        sqr = (avg - x) ** 2
        sqr[missing] = 0.0
        mean[c] = float(avg)
        std[c] = (float(np.sqrt(sqr.sum(dtype=np.float64) / (n - 1)))
                  if n > 1 else np.nan)
    return [mean, std]


def hparam_search(cfg: Config, save_weights: bool = False,
                  verbose: bool = True, sweep_id: Optional[str] = None,
                  resume: bool = False, device=None,
                  source: Optional[FoldSource] = None) -> Dict[str, Any]:
    """Serial hyperparameter search with the native controllers (JAX
    ``train/experiment.py:622-734``), or, with ``TRAIN.HPARAM_SEARCH.
    BACKEND: wandb`` where wandb imports, scheduled by the W&B sweep agent
    (:func:`~ab_line_classifier_torch.train.wandb_sweep.run_wandb_sweep`,
    resumed only by ``sweep_id``). Each trial's record (``trial``, its
    parameters, ``objective``) is appended to
    ``EXPERIMENTS/{sweep_id}.jsonl`` when it finishes; rerunning with the
    same ``sweep_id`` (``resume`` without one: the latest sweep) replays
    the finished trials into the controller and runs only the rest. Then
    ``hparam_search_<timestamp>.csv`` and the sweep plot.

    ``source``: the split to train every trial on (default: the
    :func:`resolve_datasets` split, resolved once)."""
    device = resolve_device(device)
    verbose = verbose and mesh_lib.is_main()
    search = cfg["TRAIN"]["HPARAM_SEARCH"]
    if str(search.get("BACKEND", "native")).lower() == "wandb":
        if mesh_lib.world_size() > 1:
            raise NotImplementedError(
                "TRAIN.HPARAM_SEARCH.BACKEND wandb under a process group: "
                "the W&B agent hands each trial to one process; run the "
                "sweep with one process, or with the native controller")
        # Only the import is tried here: an ImportError inside a trial
        # propagates, never reruns the search natively.
        from ab_line_classifier_torch.train import wandb_sweep
        try:
            wandb_sweep._default_wandb()
        except ImportError as e:
            print(f"wandb sweep backend unavailable ({e}); "
                  f"using the native controller")
        else:
            if resume and sweep_id is None:
                # The service owns a W&B sweep's trial history: there is no
                # local trials file to resume from.
                raise ValueError(
                    "hparam_search --resume with the wandb backend needs "
                    "an explicit --sweep-id (the service owns the trial "
                    "history); pass the sweep id printed when the sweep "
                    "was registered, or drop --resume to start a new one")
            return wandb_sweep.run_wandb_sweep(
                cfg, save_weights=save_weights, verbose=verbose,
                sweep_id=sweep_id, device=device, source=source)
    space = space_from_config(cfg.hparam_search_space())
    controller = make_controller(search["METHOD"], space,
                                 seed=int(cfg["TRAIN"]["SEED"]))
    n_evals = int(search["N_EVALS"])
    if sweep_id is None and resume:
        sweep_id = _latest_trials_file(cfg, "sweep")
        if sweep_id is None:
            print("hparam_search --resume: no previous sweep trials file "
                  "found; starting a new sweep")
    group = mesh_lib.broadcast_object(
        sweep_id or f"sweep-{time.strftime('%Y%m%d-%H%M%S')}")
    out_dir = cfg["PATHS"]["EXPERIMENTS"]
    os.makedirs(out_dir, exist_ok=True)
    trials_path = os.path.join(out_dir, f"{group}.jsonl")
    results = _records(trials_path, verbose)
    replay_trials(controller, results)
    if verbose and results:
        print(f"resuming sweep {group}: {len(results)} trials done")

    for trial in range(len(results), n_evals):
        try:
            params = controller.suggest()
        except SweepExhausted as e:
            print(f"stopping sweep early: {e} "
                  f"(N_EVALS={n_evals} > grid size)")
            break
        if verbose:
            print(f"--- sweep trial {trial}/{n_evals}: {params}")
        if source is None:
            source = source_from_datasets(cfg)
        result = perform_single_run(cfg, hparam_overrides=params,
                                    kfold_tables=source,
                                    save_weights=save_weights, group=group,
                                    verbose=verbose, device=device)
        obj = _sweep_objective(result, search["METRIC_NAME"],
                               search["METRIC_GOAL"])
        controller.observe(params, obj)
        rec = {"trial": trial, **params, "objective": obj}
        results.append(rec)
        _append_record(trials_path, rec)
    if controller.best is None:
        raise ValueError(
            "hparam search observed no trials (N_EVALS set to 0, or a "
            "resumed sweep with an empty trials file): nothing to select "
            "a best from")
    best_params, best_obj = controller.best
    if mesh_lib.is_main():
        write_csv(os.path.join(
            out_dir, f"hparam_search_{time.strftime('%Y%m%d-%H%M%S')}.csv"),
            results)
    plot_dir = cfg["PATHS"].get("EXPERIMENT_VISUALIZATIONS",
                                cfg["PATHS"]["IMAGES"])
    if len(results) >= 2 and mesh_lib.is_main():
        try:
            from ab_line_classifier_torch.viz.visualization import (
                plot_bayesian_hparam_opt, plot_hparam_search)
            if hasattr(controller, "partial_dependence"):
                plot_bayesian_hparam_opt(controller, dir_path=plot_dir)
            else:  # grid and random: the progress plot
                plot_hparam_search(results, dir_path=plot_dir)
        except Exception as e:
            print(f"(sweep plot skipped: {e})")
    if verbose:
        print(f"best: {best_params} (objective {best_obj:.4f})")
    return {"best_params": best_params, "best_objective": best_obj,
            "trials": results}


def cross_validation(cfg: Config, save_weights: bool = False,
                     verbose: bool = True, group: Optional[str] = None,
                     resume: bool = False, device=None,
                     source: Optional[FoldSource] = None) -> List[Dict]:
    """One run per fold (JAX ``train/experiment.py:1004-1055``), and the
    mean / std summary ``kfold_<timestamp>.csv``. The fold source is
    resolved once (``source``, default :func:`resolve_kfold_tables`). Each fold's record (``fold`` and its test
    metrics) is appended to ``EXPERIMENTS/{group}.jsonl`` when it
    finishes; ``resume`` (the latest k-fold run, or ``group``) skips the
    folds done. Returns the summary's rows: one per fold, then ``mean``
    and ``std``."""
    device = resolve_device(device)
    verbose = verbose and mesh_lib.is_main()
    if source is None:
        source = source_from_kfold_tables(cfg)
    n_folds = len(source.folds)
    if group is None and resume:
        group = _latest_trials_file(cfg, "kfold")
        if group is None:
            print("cross_validation --resume: no previous fold results file "
                  "found; starting a new run")
    group = mesh_lib.broadcast_object(
        group or f"kfold-{time.strftime('%Y%m%d-%H%M%S')}")
    out_dir = cfg["PATHS"]["EXPERIMENTS"]
    os.makedirs(out_dir, exist_ok=True)
    folds_path = os.path.join(out_dir, f"{group}.jsonl")
    rows = _records(folds_path, verbose)
    if verbose and rows:
        print(f"resuming k-fold run {group}: {len(rows)} folds done")
    for fold_id in range(len(rows), n_folds):
        if verbose:
            print(f"=== fold {fold_id}/{n_folds}")
        result = perform_single_run(cfg, fold_id=fold_id,
                                    kfold_tables=source,
                                    save_weights=save_weights, group=group,
                                    verbose=verbose, device=device)
        row = {"fold": fold_id, **{k: v for k, v
                                   in result.test_metrics.items()
                                   if not isinstance(v, list)}}
        rows.append(row)
        _append_record(folds_path, row)
    summary = list(rows) + mean_std_rows(rows)
    if mesh_lib.is_main():
        write_csv(os.path.join(
            out_dir, f"kfold_{time.strftime('%Y%m%d-%H%M%S')}.csv"),
            summary)
    return summary


# -- trial-parallel -------------------------------------------------------
def _union_cache(frames, rows_per_trial: Sequence[Sequence[np.ndarray]],
                 cfg: Config, device, mesh=None
                 ) -> Tuple[DeviceCachedDataset, List]:
    """The union of every trial's rows of ``frames`` (a
    :class:`FrameDataset` or :class:`FrameArrays`) uploaded once to the
    device, and each list of ``rows_per_trial`` re-indexed into it. The
    table must fit :func:`configured_cache_budget`, or, under a mesh with
    a ``data`` axis of D ranks, D times it (then split over that axis):
    every trial gathers from it at every step, and there is no streaming
    form (the JAX package holds it in device memory too); it raises with
    the sizes when it does not fit."""
    union = np.unique(np.concatenate([np.asarray(r) for rows in
                                      rows_per_trial for r in rows]))
    h, w = frames.img_dim
    nbytes = len(union) * h * w * 3
    budget = configured_cache_budget(cfg, device)
    n_data = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    if nbytes > budget * n_data:
        raise MemoryError(
            f"the trial-parallel frame table ({len(union)} frames of "
            f"{h}x{w}x3 uint8, {nbytes} bytes) does not fit the device "
            f"cache budget of {budget} bytes (half the free device memory, "
            f"or TRAIN.MEMORY_LIMIT) on each of {n_data} data ranks; use "
            f"the serial experiment")
    if nbytes > budget:
        cache = ShardedDeviceCachedDataset(frames.take(union), device, mesh)
    else:
        cache = DeviceCachedDataset(frames.take(union), device)
    return cache, [[np.searchsorted(union, r) for r in rows]
                   for rows in rows_per_trial]


def load_pretrained_overlay(cfg: Config, spec: ModelSpec, seed: int,
                            verbose: bool = True):
    """``USE_PRETRAINED``'s warm start for the trial-parallel trainer:
    ``(state_dict, layer_names)``, the names of the layers the file set
    (a ``.h5``: those whose weights differ from the seeded initialization
    it was imported over), None for a port checkpoint (every layer)."""
    path = cfg["PATHS"]["PRETRAINED_WEIGHTS"]
    state = load_pretrained_state(path, spec, seed, verbose)
    if not path.endswith(".h5"):
        return state, None
    base = spec.logits_module(
        generator=torch.Generator().manual_seed(seed)).state_dict()
    names = sorted({k.split(".", 1)[0] for k, v in state.items()
                    if not torch.equal(v, base[k])})
    return state, names


def lr_candidates(cfg: Config, n_trials: Optional[int] = None
                  ) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, str]]]:
    """The trial-parallel LR search's candidates (JAX
    ``train/experiment.py:735-835``): ``(trial_lrs, phase_vars)``. An
    ``LR`` space is a deterministic grid (log-spaced for ``float_log``) of
    ``N_EVALS`` (or ``n_trials``) points, one factor in every phase
    (``phase_vars`` None); ``LR_EXTRACT`` / ``LR_FINETUNE`` (cutoffvgg16's
    two phases) are drawn per trial from ``RandomState(TRAIN.SEED)``, an
    unswept one at its HPARAMS value, ``phase_vars`` mapping each phase to
    its variable. Other variables cannot be update-scaled: they are
    ignored with a message."""
    search = cfg["TRAIN"]["HPARAM_SEARCH"]
    space = {v.name: v for v in space_from_config(cfg.hparam_search_space())}
    n = int(n_trials or search["N_EVALS"])

    def grid(var, k):
        lo, hi = float(var.range[0]), float(var.range[1])
        if var.type == "float_log":
            return np.exp(np.linspace(np.log(lo), np.log(hi), k))
        return np.linspace(lo, hi, k)

    def samples(var, k, rng):
        lo, hi = float(var.range[0]), float(var.range[1])
        if var.type == "float_log":
            return np.exp(rng.uniform(np.log(lo), np.log(hi), k))
        return rng.uniform(lo, hi, k)

    hparams = cfg.model_hparams()
    rng = np.random.RandomState(int(cfg["TRAIN"]["SEED"]))
    lr_names = {"LR", "LR_EXTRACT", "LR_FINETUNE"}
    ignored = sorted(set(space) - lr_names)
    if ignored:
        print(f"lr_search_parallel: only learning rates can be update-scaled"
              f" trial-parallel; ignoring search variables {ignored} "
              f"(they stay at their HPARAMS defaults — use the serial "
              f"hparam_search to sweep them)")
    if "LR" in space and ({"LR_EXTRACT", "LR_FINETUNE"} & set(space)):
        raise ValueError(
            "HPARAM_SEARCH defines both LR and LR_EXTRACT/LR_FINETUNE — "
            "ambiguous for the trial-parallel sweep (the phase LRs would "
            "silently stay at their HPARAMS defaults); keep one style")
    if "LR" in space:
        return {"LR": grid(space["LR"], n)}, None
    if "LR_EXTRACT" in space or "LR_FINETUNE" in space:
        trial_lrs = {}
        for name in ("LR_EXTRACT", "LR_FINETUNE"):
            trial_lrs[name] = (samples(space[name], n, rng) if name in space
                               else np.full(n, float(hparams[name])))
        return trial_lrs, {"extract": "LR_EXTRACT",
                           "finetune": "LR_FINETUNE"}
    raise ValueError(
        "lr_search_parallel needs LR (or LR_EXTRACT/LR_FINETUNE) in "
        "HPARAM_SEARCH (other variables cannot be update-scaled)")


def select_trial(history: List[Dict], metric_name: str, goal: str
                 ) -> Tuple[np.ndarray, int, str, str]:
    """Each trial's objective, the metric at its best-val-loss epoch (the
    serial sweep's semantics), and the winner: ``(per_trial, best,
    column, goal)``. A metric the history lacks falls back to val_auc,
    maximized, with a message."""
    key = metric_name.split("/")[-1]
    if key in history[0]:
        col = key
    else:
        print(f"lr_search_parallel: metric {key!r} not in per-epoch history "
              f"({sorted(k for k in history[0] if k.startswith('val_'))}); "
              f"selecting by val_auc (maximize) instead")
        col, goal = "val_auc", "maximize"
    stacked = np.stack([h[col] for h in history])
    best_epoch = np.stack([h["val_loss"] for h in history]).argmin(axis=0)
    per_trial = stacked[best_epoch, np.arange(stacked.shape[1])]
    best = int(np.argmax(per_trial) if goal == "maximize"
               else np.argmin(per_trial))
    return per_trial, best, col, goal


def _parallel_trainer(cfg: Config, spec: ModelSpec, n: int, cls_w, biases,
                      device, label: str, mesh=None):
    from ab_line_classifier_torch.parallel.trial_parallel import (
        ParallelFoldTrainer)

    mixed = bool(cfg["TRAIN"].get("MIXED_PRECISION", False))
    return ParallelFoldTrainer(
        spec, n, class_weights=cls_w, output_biases=biases,
        aug_config=dict(cfg["TRAIN"]["DATA_AUG"]),
        seed=int(cfg["TRAIN"]["SEED"]), compute_dtype=compute_dtype(mixed),
        progress_label=label, device=device, mesh=mesh)


def _fit_parallel(cfg: Config, trainer, spec, cache, train_idx, val_idx,
                  verbose, checkpoint_dir, resume, lr_factors=None):
    warm = None
    if cfg["TRAIN"].get("USE_PRETRAINED", False):
        warm = load_pretrained_overlay(cfg, spec, int(cfg["TRAIN"]["SEED"]),
                                       verbose)
    return trainer.fit(cache, None, train_idx, val_idx,
                       batch_size=cfg.batch_size,
                       epochs=int(cfg["TRAIN"]["EPOCHS"]),
                       patience=int(cfg["TRAIN"]["PATIENCE"]),
                       lr_factors=lr_factors, verbose=verbose,
                       checkpoint_dir=checkpoint_dir, resume=resume,
                       warm_start=warm)


def lr_search_parallel(cfg: Config, n_trials: Optional[int] = None,
                       verbose: bool = True,
                       checkpoint_dir: Optional[str] = None,
                       resume: bool = False, device=None,
                       source: Optional[FoldSource] = None,
                       mesh=None) -> Dict[str, Any]:
    """Trial-parallel learning-rate search (JAX
    ``train/experiment.py:735-909``): every candidate rate
    (:func:`lr_candidates`) trains at once, one stacked model whose trials
    differ only by their learning-rate factor (the updates are linear in
    the rate), on the same train split with its class weights and output
    bias. Each trial's objective is its metric at its best-val-loss epoch
    (:func:`select_trial`); ``lr_sweep_parallel_<timestamp>.csv`` holds
    one row per trial and the sweep plot follows. ``checkpoint_dir``
    saves the stacked state every epoch and ``resume`` continues from it.

    ``source``: the split (default :func:`resolve_datasets`'), fold 0's
    train and val rows. ``mesh``: the trials shard over its ``trial``
    axis, each trial's batches over its ``data`` axis (JAX
    ``train/experiment.py:736-749``)."""
    device = resolve_device(device)
    verbose = verbose and mesh_lib.is_main()
    ensure_output_dirs(cfg)
    search = cfg["TRAIN"]["HPARAM_SEARCH"]
    hparams = cfg.model_hparams()
    trial_lrs, phase_vars = lr_candidates(cfg, n_trials)
    n = len(next(iter(trial_lrs.values())))
    space = {v.name for v in space_from_config(cfg.hparam_search_space())}

    if source is None:
        source = source_from_datasets(cfg)
    tr_rows, va_rows, _ = source.folds.fold(0)
    cache, (train_idx, val_idx) = _union_cache(
        source.frames, [[tr_rows] * n, [va_rows] * n], cfg, device, mesh)
    train_labels = np.asarray(source.frames.labels)[tr_rows]
    mixed = bool(cfg["TRAIN"].get("MIXED_PRECISION", False))
    spec = build_model(cfg.model_name, hparams, cfg.img_dim + (3,),
                       cfg.n_classes, mixed_precision=mixed,
                       total_epochs=int(cfg["TRAIN"]["EPOCHS"]))
    trainer = _parallel_trainer(
        cfg, spec, n, np.tile(class_weight_array(train_labels,
                                                 cfg.n_classes), (n, 1)),
        np.tile(output_bias_array(train_labels, cfg.n_classes), (n, 1)),
        device, "trials", mesh)
    # Each trial's factor against the HPARAMS rate, per phase for
    # cutoffvgg16's pair.
    if phase_vars is None:
        lr_factors = trial_lrs["LR"] / float(hparams["LR"])
    else:
        lr_factors = {phase: trial_lrs[var] / float(hparams[var])
                      for phase, var in phase_vars.items()}
    best_vars, history = _fit_parallel(
        cfg, trainer, spec, cache, train_idx, val_idx, verbose,
        checkpoint_dir, resume, lr_factors)
    if not history:
        raise RuntimeError(
            "lr_search_parallel: no epoch history (EPOCHS=0) — no "
            "per-trial objective to select from")
    per_trial, best_t, col, goal = select_trial(
        history, search["METRIC_NAME"], search["METRIC_GOAL"])
    swept = {k: v for k, v in trial_lrs.items()
             if phase_vars is None or k in space}
    rows = [{"trial": t, **{k: float(v[t]) for k, v in swept.items()},
             "objective": float(per_trial[t])} for t in range(n)]
    if mesh_lib.is_main():
        out_dir = cfg["PATHS"]["EXPERIMENTS"]
        os.makedirs(out_dir, exist_ok=True)
        write_csv(os.path.join(
            out_dir,
            f"lr_sweep_parallel_{time.strftime('%Y%m%d-%H%M%S')}.csv"), rows)
        try:
            from ab_line_classifier_torch.viz.visualization import (
                plot_hparam_search)
            plot_hparam_search(rows, goal=goal, dir_path=cfg["PATHS"].get(
                "EXPERIMENT_VISUALIZATIONS", cfg["PATHS"]["IMAGES"]))
        except Exception as e:
            print(f"(sweep plot skipped: {e})")
    best_params = {k: float(v[best_t]) for k, v in swept.items()}
    if verbose:
        print(f"best {best_params} ({col}={per_trial[best_t]:.4f})")
    from ab_line_classifier_torch.parallel.trial_parallel import trial_state
    return {"best_params": best_params,
            "best_objective": float(per_trial[best_t]), "trials": rows,
            "history": history, "best_vars": trial_state(best_vars, best_t)}


def cross_validation_parallel(cfg: Config, verbose: bool = True,
                              checkpoint_dir: Optional[str] = None,
                              resume: bool = False, device=None,
                              source: Optional[FoldSource] = None,
                              mesh=None) -> List[Dict]:
    """Every fold at once (JAX ``train/experiment.py:912-1001``): one
    stacked model, fold t training on its train rows with its own class
    weights and output bias, early-stopped on its val rows; then each
    fold's test rows through the port's ``Predictor`` with the fold's
    best weights (kernel B1 on every test batch), and
    ``kfold_parallel_<timestamp>.csv``: a row per fold, then ``mean`` and
    ``std``. Returns those rows. ``source``: the fold source (default
    :func:`resolve_kfold_tables`'); ``checkpoint_dir`` / ``resume`` /
    ``mesh`` as :func:`lr_search_parallel` (the test sets served over every
    rank of the mesh)."""
    from ab_line_classifier_torch.parallel.trial_parallel import trial_state

    device = resolve_device(device)
    verbose = verbose and mesh_lib.is_main()
    ensure_output_dirs(cfg)
    if source is None:
        source = source_from_kfold_tables(cfg)
    n_folds = len(source.folds)
    split = [source.folds.fold(k) for k in range(n_folds)]
    cache, (train_idx, val_idx) = _union_cache(
        source.frames, [[s[0] for s in split], [s[1] for s in split]], cfg,
        device, mesh)
    labels = np.asarray(source.frames.labels)
    cls_w = np.stack([class_weight_array(labels[s[0]], cfg.n_classes)
                      for s in split])
    biases = np.stack([output_bias_array(labels[s[0]], cfg.n_classes)
                       for s in split])
    mixed = bool(cfg["TRAIN"].get("MIXED_PRECISION", False))
    spec = build_model(cfg.model_name, cfg.model_hparams(),
                       cfg.img_dim + (3,), cfg.n_classes,
                       mixed_precision=mixed,
                       total_epochs=int(cfg["TRAIN"]["EPOCHS"]))
    trainer = _parallel_trainer(cfg, spec, n_folds, cls_w, biases, device,
                                "folds", mesh)
    best, _ = _fit_parallel(cfg, trainer, spec, cache, train_idx, val_idx,
                            verbose, checkpoint_dir, resume)
    del trainer, cache

    rows = []
    for k in range(n_folds):
        predictor = Predictor(spec, trial_state(best, k),
                              batch_size=cfg.batch_size,
                              compute_dtype=compute_dtype(mixed),
                              device=device, mesh=mesh)
        test = source.frames.take(split[k][2])
        probs = predictor.predict_dataset(test)
        lab = np.asarray(test.labels)
        preds = (probs[:, 1] >= 0.5).astype(int)
        m = compute_metrics(cfg.classes, lab, preds, probs)
        rows.append({"fold": k, **{key: v for key, v in m.items()
                                   if not isinstance(v, list)}})
    summary = rows + mean_std_rows(rows)
    if mesh_lib.is_main():
        out_dir = cfg["PATHS"]["EXPERIMENTS"]
        os.makedirs(out_dir, exist_ok=True)
        write_csv(os.path.join(
            out_dir, f"kfold_parallel_{time.strftime('%Y%m%d-%H%M%S')}.csv"),
            summary)
    return summary


def default_checkpoint_dir(cfg: Config, experiment: str) -> str:
    """Where per-epoch resume checkpoints live when ``--resume`` names no
    ``--checkpoint-dir``."""
    return os.path.join(cfg["PATHS"]["MODEL_WEIGHTS"], "_resume", experiment)


def train_experiment(cfg: Config, experiment: Optional[str] = None,
                     save_weights: bool = False, verbose: bool = True,
                     trial_parallel: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     resume: bool = False, sweep_id: Optional[str] = None,
                     device=None):
    """Run ``TRAIN.EXPERIMENT_TYPE`` (or ``experiment``) on ``device``
    (``cuda`` unless asked for the CPU; raises at once without a GPU), as
    the JAX package dispatches (``train/experiment.py:1068-1111``).
    ``single_train`` and the trial-parallel experiments
    (``trial_parallel``: :func:`lr_search_parallel` for
    ``hparam_search``, :func:`cross_validation_parallel` for
    ``cross_validation``, over the ``PARALLEL.MESH`` mesh) checkpoint
    every epoch into ``checkpoint_dir`` and resume from it; the serial
    sweeps resume by trial or fold (``sweep_id`` names the run, default
    the latest)."""
    device = resolve_device(device)
    experiment = experiment or cfg["TRAIN"]["EXPERIMENT_TYPE"]
    if resume and checkpoint_dir is None:
        checkpoint_dir = default_checkpoint_dir(cfg, experiment)
    if trial_parallel and experiment in ("hparam_search",
                                         "cross_validation"):
        run = (lr_search_parallel if experiment == "hparam_search"
               else cross_validation_parallel)
        return run(cfg, verbose=verbose, checkpoint_dir=checkpoint_dir,
                   resume=resume, device=device,
                   mesh=mesh_lib.mesh_from_config(cfg, device))
    if experiment == "single_train":
        return perform_single_run(cfg, save_weights=save_weights,
                                  verbose=verbose,
                                  checkpoint_dir=checkpoint_dir,
                                  resume=resume, device=device)
    if experiment == "hparam_search":
        return hparam_search(cfg, save_weights=save_weights, verbose=verbose,
                             sweep_id=sweep_id, resume=resume, device=device)
    if experiment == "cross_validation":
        return cross_validation(cfg, save_weights=save_weights,
                                verbose=verbose, group=sweep_id,
                                resume=resume, device=device)
    raise ValueError(
        "Invalid entry in TRAIN > EXPERIMENT_TYPE field of config.yml.")
