"""PyTorch port, training CLI: ``python -m ab_line_classifier_torch.train
--device cpu`` runs ``single_train`` for cutoffvgg16 through both phases on
a synthetic JPEG workspace (``conftest.derive_workspace_config``; 32x32,
mixed precision, the config's augmentation), logs its epochs and
validation prediction tables locally, and saves a port checkpoint that
``python -m ab_line_classifier_torch.predict --device cpu`` serves. Without
``--device cpu`` and without a GPU the command raises. Cross-validation
and hyperparameter search run on the same workspace, and the local
artifact store is read as the JAX package reads it; ``--trial-parallel``
runs both experiments with every fold or trial at once; what waits for
later slices (a device mesh with a trial axis, fetching a pinned W&B
artifact, the W&B sweep backend) raises ``NotImplementedError``.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from conftest import REPO_ROOT, cli_env, derive_workspace_config

from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_torch.config import load_config
from ab_line_classifier_torch.train.experiment import (resolve_datasets,
                                                       resolve_kfold_tables,
                                                       train_experiment)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("torch_train"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=10,
                                        clips_per_patient=1,
                                        frames_per_clip=4, hw=(32, 32),
                                        seed=0)
    d = derive_workspace_config(ws, fcsv, ccsv, fdir)
    d["DATA"].update({"VAL_SPLIT": 0.2, "TEST_SPLIT": 0.2})
    d["TRAIN"].update({"MODEL_DEF": "cutoffvgg16", "EPOCHS": 2,
                       "BATCH_SIZE": 8, "PATIENCE": 5,
                       "EXPERIMENT_TYPE": "single_train"})
    d["HPARAMS"]["CUTOFFVGG16"]["EXTRACT_EPOCHS"] = 1
    path = os.path.join(ws, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return ws, path


def _run(module, cfg_path, *args):
    return subprocess.run(
        [sys.executable, "-m", module, "--config", cfg_path, *args],
        capture_output=True, text=True, timeout=600, cwd=REPO_ROOT,
        env=cli_env(cfg_path))


def test_train_cli_writes_a_checkpoint_predict_serves(workspace):
    ws, cfg_path = workspace
    r = _run("ab_line_classifier_torch.train", cfg_path, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[extract] epoch 0" in r.stdout
    assert "[finetune] epoch 2" in r.stdout

    models = glob.glob(os.path.join(ws, "results", "models", "model*"))
    assert len(models) == 1
    with open(os.path.join(models[0], "meta.json")) as f:
        meta = json.load(f)
    assert meta["model_name"] == "cutoffvgg16" and meta["mixed_precision"]
    state = torch.load(os.path.join(models[0], "state.pt"),
                       weights_only=True)
    assert all(v.dtype == torch.float32 for v in state.values())

    runs = glob.glob(os.path.join(ws, "results", "runs", "*"))
    assert len(runs) == 1
    with open(os.path.join(runs[0], "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    epochs = [e for e in events if e["event"] == "epoch"]
    # EXTRACT_EPOCHS 1, then EPOCHS - EXTRACT_EPOCHS + 1 = 2 finetune.
    assert [e["phase"] for e in epochs] == ["extract", "finetune",
                                            "finetune"]
    assert all(np.isfinite(e["train/loss"]) and np.isfinite(e["val/loss"])
               for e in epochs)
    assert any(e["event"] == "test" for e in events)
    tables = sorted(glob.glob(os.path.join(runs[0], "val_predictions",
                                           "*.csv")))
    assert len(tables) == 3
    assert list(pd.read_csv(tables[0]).columns) == [
        "epoch", "idx", "frame", "label", "probs", "pred"]

    r = _run("ab_line_classifier_torch.predict", cfg_path, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    frames = pd.read_csv(os.path.join(ws, "frames.csv"))
    preds = glob.glob(os.path.join(ws, "results", "predictions",
                                   "*_frames_predictions*.csv"))
    assert len(preds) == 1
    probs = pd.read_csv(preds[0])[["a_lines", "b_lines"]].to_numpy()
    assert probs.shape == (len(frames), 2) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_train_cli_raises_without_a_gpu(workspace):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    _, cfg_path = workspace
    r = _run("ab_line_classifier_torch.train", cfg_path)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_later_slices_raise(workspace, tmp_path):
    """What still waits for a later slice raises: trial-parallel
    experiments on a mesh with a trial axis (multi-device training), a
    W&B artifact version pinned for the split or the folds that the store
    does not hold, and the W&B sweep backend where wandb is importable
    (without it the sweep says so and runs the native controller)."""
    ws, cfg_path = workspace
    cfg = load_config(cfg_path)
    meshed = cfg.replace(PARALLEL={"MESH": {"DATA": 1, "TRIAL": 2}})
    for experiment in ("cross_validation", "hparam_search"):
        with pytest.raises(NotImplementedError, match="multi-device"):
            train_experiment(meshed, experiment=experiment,
                             trial_parallel=True, device="cpu")
    pinned = cfg.replace_path("WANDB.TRAIN_VAL_TEST_ARTIFACT_VERSION", "v3")
    with pytest.raises(NotImplementedError, match="W&B"):
        resolve_datasets(pinned)
    pinned = cfg.replace_path("WANDB.K_FOLD_CROSS_VAL_ARTIFACT_VERSION",
                              "latest")
    with pytest.raises(NotImplementedError, match="W&B"):
        resolve_kfold_tables(pinned)
    with pytest.raises(NotImplementedError, match="W&B"):
        train_experiment(pinned, experiment="cross_validation", device="cpu")
    import types

    wandb_cfg = cfg.replace_path("TRAIN.HPARAM_SEARCH.BACKEND", "wandb")
    sys.modules["wandb"] = types.ModuleType("wandb")
    try:
        with pytest.raises(NotImplementedError, match="W&B sweep"):
            train_experiment(wandb_cfg, experiment="hparam_search",
                             device="cpu")
    finally:
        del sys.modules["wandb"]


def test_store_and_partitions_resolve_like_jax(workspace, tmp_path):
    """The local artifact store's TrainValTest artifact (source 3) is read,
    as the JAX package reads it, and a pinned version the store already
    fetched is served from it; partition CSVs (source 2) win over the
    store."""
    from ab_line_classifier_tpu.config import Config as JaxConfig
    from ab_line_classifier_tpu.train.experiment import (
        resolve_datasets as jax_resolve_datasets)
    from ab_line_classifier_torch.data.artifacts import ArtifactStore

    ws, cfg_path = workspace
    store_root = str(tmp_path / "artifacts")
    cfg = load_config(cfg_path).replace_path("TRACKER.ARTIFACTS_DIR",
                                             store_root)
    store = ArtifactStore(store_root)
    store.log_images(cfg["PATHS"]["FRAME_TABLE"], cfg["PATHS"]["CLIPS_TABLE"],
                     frames_dir=cfg["PATHS"]["FRAMES"])
    store.log_model_dev_holdout(cfg)
    path = store.log_train_val_test(cfg)
    got = resolve_datasets(cfg)
    want = jax_resolve_datasets(JaxConfig(cfg.to_dict()))
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    assert got[3] == want[3]
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    meta["source"] = "wandb:TrainValTest:v7"
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    pinned = cfg.replace_path("WANDB.TRAIN_VAL_TEST_ARTIFACT_VERSION", "v7")
    for g, w in zip(resolve_datasets(pinned)[:3], got[:3]):
        pd.testing.assert_frame_equal(g, w)
    # Partition CSVs win over the store.
    part = tmp_path / "partitions"
    (part / "frames").mkdir(parents=True)
    frames = pd.read_csv(os.path.join(ws, "frames.csv"))
    for i, name in enumerate(("train", "val", "test")):
        frames.iloc[i::3].to_csv(part / "frames" / f"{name}.csv",
                                 index=False)
    tr, va, te, _ = resolve_datasets(
        cfg.replace_path("PATHS.PARTITIONS", str(part)))
    assert (len(tr), len(va), len(te)) == (14, 13, 13)


def test_cross_validation_and_hparam_search_run(workspace, capsys):
    """Both experiments run on the CPU with the workspace's cutoffvgg16
    (both phases; float32, and at most 2 extract epochs a trial, for the
    CPU's time): a record per fold or trial, the mean and std rows, the
    test plots; the sweep asks for the W&B backend and, wandb not being
    importable, says so and runs the native controller; without a device
    they need a GPU."""
    import importlib.util

    ws, cfg_path = workspace
    backend = "native" if importlib.util.find_spec("wandb") else "wandb"
    cfg = load_config(cfg_path).replace(
        DATA={"K_FOLD_VALIDATION_SPLIT": 0.3},
        TRAIN={"N_FOLDS": 3, "EPOCHS": 1, "MIXED_PRECISION": False,
               "HPARAM_SEARCH": {"N_EVALS": 2, "METHOD": "random",
                                 "BACKEND": backend}},
        HPARAM_SEARCH={"CUTOFFVGG16": {"EXTRACT_EPOCHS": {"RANGE": [1, 2]}}},
        PATHS={"EXPERIMENTS": os.path.join(ws, "experiments_run"),
               "IMAGES": os.path.join(ws, "figures_run")})
    summary = train_experiment(cfg, experiment="cross_validation",
                               device="cpu", verbose=False)
    assert [r["fold"] for r in summary] == [0, 1, 2, "mean", "std"]
    assert all(np.isfinite(r["accuracy"]) for r in summary)
    capsys.readouterr()
    out = train_experiment(cfg, experiment="hparam_search", device="cpu",
                           verbose=False)
    if backend == "wandb":
        assert "using the native controller" in capsys.readouterr().out
    assert [t["trial"] for t in out["trials"]] == [0, 1]
    assert set(out["best_params"]) == {"LR_EXTRACT", "LR_FINETUNE",
                                       "DROPOUT", "EXTRACT_EPOCHS"}
    exp = os.path.join(ws, "experiments_run")
    assert len(glob.glob(os.path.join(exp, "kfold-*.jsonl"))) == 1
    assert len(glob.glob(os.path.join(exp, "sweep-*.jsonl"))) == 1
    assert len(glob.glob(os.path.join(exp, "*.csv"))) == 2
    assert len(glob.glob(os.path.join(ws, "figures_run",
                                      "test_roc_*.png"))) >= 1
    if not torch.cuda.is_available():
        for experiment in ("cross_validation", "hparam_search"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                train_experiment(cfg, experiment=experiment)


def test_trial_parallel_cli_runs_both_experiments(workspace):
    """``--trial-parallel --device cpu`` trains every fold (3) and every
    LR trial (3, a log grid over LR_EXTRACT's box and the seeded draws of
    JAX's two-phase search) of the workspace's cutoffvgg16 at once and
    writes ``kfold_parallel_*.csv`` / ``lr_sweep_parallel_*.csv`` with the
    JAX package's columns; without ``--device cpu`` and without a GPU it
    raises."""
    ws, cfg_path = workspace
    d = yaml.safe_load(open(cfg_path))
    d["DATA"]["K_FOLD_VALIDATION_SPLIT"] = 0.3
    d["TRAIN"].update({"N_FOLDS": 3, "EPOCHS": 1, "MIXED_PRECISION": False})
    d["TRAIN"]["HPARAM_SEARCH"]["N_EVALS"] = 3
    d["HPARAM_SEARCH"]["CUTOFFVGG16"] = {
        "LR_EXTRACT": {"TYPE": "float_log", "RANGE": [1e-5, 1e-3]},
        "DROPOUT": {"TYPE": "float_uniform", "RANGE": [0.2, 0.5]}}
    exp = os.path.join(ws, "experiments_parallel")
    d["PATHS"]["EXPERIMENTS"] = exp
    path = os.path.join(ws, "config_parallel.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    for experiment, pattern, columns in (
            ("cross_validation", "kfold_parallel_*.csv", None),
            ("hparam_search", "lr_sweep_parallel_*.csv",
             ["trial", "LR_EXTRACT", "objective"])):
        r = _run("ab_line_classifier_torch.train", path, "--device", "cpu",
                 "--experiment", experiment, "--trial-parallel",
                 "--no-save-weights")
        assert r.returncode == 0, r.stderr[-3000:]
        out = glob.glob(os.path.join(exp, pattern))
        assert len(out) == 1, out
        table = pd.read_csv(out[0])
        if columns is None:
            assert list(table["fold"].astype(str)) == ["0", "1", "2",
                                                       "mean", "std"]
            assert np.isfinite(table["accuracy"]).all()
        else:
            assert list(table.columns) == columns
            assert list(table["trial"]) == [0, 1, 2]
            assert "ignoring search variables ['DROPOUT']" in r.stdout
    if not torch.cuda.is_available():
        r = _run("ab_line_classifier_torch.train", path, "--experiment",
                 "cross_validation", "--trial-parallel")
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr


@pytest.mark.parametrize("shuffle,drop_remainder",
                         [(False, False), (True, False), (True, True)])
def test_streamed_epochs_match_jax(workspace, shuffle, drop_remainder):
    """The host pipeline's epochs over the workspace's JPEGs (40 frames,
    batch 16: one partial batch) give the JAX package's rows, masks and
    pixels (its PIL path), shuffled or not, the partial batch padded by
    wraparound or dropped."""
    from ab_line_classifier_tpu.data.pipeline import (
        FrameDataset as JaxFrameDataset)
    from ab_line_classifier_torch.data.pipeline import FrameDataset

    ws, _ = workspace
    frames = pd.read_csv(os.path.join(ws, "frames.csv"))
    fdir = os.path.join(ws, "frames")
    kw = dict(shuffle=shuffle, seed=5, drop_remainder=drop_remainder)
    want = list(JaxFrameDataset(frames, fdir, img_dim=(32, 32),
                                use_native=False).batches(16, **kw))
    got = list(FrameDataset(frames, fdir, img_dim=(32, 32)).batches(16, **kw))
    assert len(got) == len(want) == (2 if drop_remainder else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("shuffle,drop_remainder",
                         [(False, False), (True, False), (True, True)])
def test_array_epochs_match_jax(workspace, shuffle, drop_remainder):
    """The same epochs from frames already decoded (``FrameArrays``, served
    from host memory, and taken by rows as a fold takes them) give the JAX
    package's rows, masks, pixels and labels."""
    from ab_line_classifier_tpu.data.pipeline import (
        FrameDataset as JaxFrameDataset)
    from ab_line_classifier_torch.data.pipeline import (FrameArrays,
                                                        FrameDataset)

    ws, _ = workspace
    frames = pd.read_csv(os.path.join(ws, "frames.csv"))
    fdir = os.path.join(ws, "frames")
    rows = np.random.RandomState(1).permutation(len(frames))
    kw = dict(shuffle=shuffle, seed=5, drop_remainder=drop_remainder)
    want = list(JaxFrameDataset(frames.iloc[rows], fdir, img_dim=(32, 32),
                                use_native=False).batches(16, **kw))
    ds = FrameDataset(frames, fdir, img_dim=(32, 32))
    arrays = FrameArrays(*ds.load_all(), ds.frame_paths).take(rows)
    assert arrays.frame_paths == list(frames["Frame Path"].iloc[rows])
    got = list(arrays.batches(16, **kw))
    assert len(got) == len(want) == (2 if drop_remainder else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.images, w.images)
        np.testing.assert_array_equal(g.labels, w.labels)
