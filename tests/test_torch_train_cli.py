"""PyTorch port, training CLI: ``python -m ab_line_classifier_torch.train
--device cpu`` runs ``single_train`` for cutoffvgg16 through both phases on
a synthetic JPEG workspace (``conftest.derive_workspace_config``; 32x32,
mixed precision, the config's augmentation), logs its epochs and
validation prediction tables locally, and saves a port checkpoint that
``python -m ab_line_classifier_torch.predict --device cpu`` serves. Without
``--device cpu`` and without a GPU the command raises. The experiment
types and data sources that wait for later slices raise
``NotImplementedError``.
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
    ws, cfg_path = workspace
    cfg = load_config(cfg_path)
    for kw in ({"experiment": "cross_validation"},
               {"experiment": "hparam_search"}, {"trial_parallel": True}):
        with pytest.raises(NotImplementedError):
            train_experiment(cfg, device="cpu", **kw)
    pinned = cfg.replace_path("WANDB.TRAIN_VAL_TEST_ARTIFACT_VERSION", "v3")
    with pytest.raises(NotImplementedError, match="W&B"):
        resolve_datasets(pinned)
    store = tmp_path / "artifacts"
    (store / "TrainValTest" / "v0").mkdir(parents=True)
    (store / "TrainValTest" / "v0" / "metadata.json").write_text("{}")
    local = cfg.replace_path("TRACKER.ARTIFACTS_DIR", str(store))
    with pytest.raises(NotImplementedError, match="artifact store"):
        resolve_datasets(local)
    # Partition CSVs win over both later sources.
    part = tmp_path / "partitions"
    (part / "frames").mkdir(parents=True)
    frames = pd.read_csv(os.path.join(ws, "frames.csv"))
    for i, name in enumerate(("train", "val", "test")):
        frames.iloc[i::3].to_csv(part / "frames" / f"{name}.csv",
                                 index=False)
    tr, va, te, _ = resolve_datasets(
        local.replace_path("PATHS.PARTITIONS", str(part)))
    assert (len(tr), len(va), len(te)) == (14, 13, 13)


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
