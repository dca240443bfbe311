"""PyTorch port, serial cross-validation and hyperparameter search
(``train/experiment.py``) against the JAX package's, on the synthetic JPEG
workspace of ``test_torch_train_cli.py`` (12 patients, 48 frames, 32x32).

Both packages train a small cnn0 (2 blocks of 8 and 16 filters, dense 16,
dropout 0, no augmentation, float32, batch 8, one epoch) from the same
Keras ``.h5`` (``TRAIN.USE_PRETRAINED``); cross-validation over 3 folds,
a random sweep of 3 trials and a Bayesian one of 4 (the fourth suggestion
from the GP) over ``LR`` and ``L2_LAMBDA``, scored by the best epoch's
validation loss (minimized). Held exactly: each fold's train, val and
test frames, each trial's parameters, the JSONL records' keys and order,
the summary CSVs' columns and rows (and the port's CSV writer, given the
JAX package's records, writes the JAX package's CSV byte for byte), the
run directories' groups and fold ids. Per-fold test metrics and trial
objectives within 1e-4 relative (a few float32 steps), with the trials
ranked alike. The port's runs are interrupted after their first fold or
trial and resumed: the finished records stay byte-identical and only the
rest run. The ROC, confusion-matrix and sweep PNGs exist. Also held
against the JAX package: the trials-file reader (torn and corrupt
files), the sweep objective, and the summary CSV's bytes against pandas
with missing cells and a single fold.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

from conftest import REPO_ROOT, cli_env, derive_workspace_config

from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_torch.train import experiment as E

RTOL = 1e-4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import jax

    from ab_line_classifier_tpu.models import build_model
    from ab_line_classifier_tpu.models.weights import export_h5_weights

    ws = str(tmp_path_factory.mktemp("torch_experiments"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=12,
                                        clips_per_patient=1,
                                        frames_per_clip=4, hw=(32, 32),
                                        seed=0)
    d = derive_workspace_config(ws, fcsv, ccsv, fdir)
    d["DATA"]["K_FOLD_VALIDATION_SPLIT"] = 0.3
    d["TRAIN"].update({
        "MODEL_DEF": "cnn0", "EPOCHS": 1, "BATCH_SIZE": 8, "N_FOLDS": 3,
        "MIXED_PRECISION": False, "USE_PRETRAINED": True, "DATA_AUG": {}})
    d["TRAIN"]["HPARAM_SEARCH"].update({
        "N_EVALS": 3, "METHOD": "random", "METRIC_NAME": "epoch/val_loss",
        "METRIC_GOAL": "minimize"})
    d["HPARAMS"]["CNN0"].update({"DROPOUT": 0.0, "BLOCKS": 2,
                                 "INIT_FILTERS": 8, "NODES_DENSE0": 16})
    d["HPARAM_SEARCH"]["CNN0"] = {
        "LR": {"TYPE": "float_log", "RANGE": [1e-4, 1e-3]},
        "L2_LAMBDA": {"TYPE": "float_log", "RANGE": [1e-5, 1e-3]}}
    spec = build_model("cnn0", d["HPARAMS"]["CNN0"], (32, 32, 3), 2)
    h5 = os.path.join(ws, "pretrained.h5")
    export_h5_weights(h5, spec.init_variables(jax.random.PRNGKey(3)),
                      graph=spec.graph)
    d["PATHS"]["PRETRAINED_WEIGHTS"] = h5
    return ws, d


def config(workspace, name, **search):
    """The workspace config with its outputs under ``<ws>/<name>/``; the
    path of its YAML."""
    ws, d = workspace
    d = yaml.safe_load(yaml.safe_dump(d))
    root = os.path.join(ws, name)
    for key in ("EXPERIMENTS", "IMAGES", "MODEL_WEIGHTS",
                "EXPERIMENT_VISUALIZATIONS"):
        d["PATHS"][key] = os.path.join(root, key.lower())
    d["TRACKER"]["DIR"] = os.path.join(root, "runs")
    d["TRAIN"]["HPARAM_SEARCH"].update(search)
    path = os.path.join(ws, f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def run_jax(path, experiment):
    from ab_line_classifier_tpu.config import load_config
    from ab_line_classifier_tpu.train.experiment import train_experiment

    return train_experiment(load_config(path), experiment=experiment,
                            verbose=False)


class Interrupted(Exception):
    pass


def run_port_interrupted(monkeypatch, path, experiment):
    """The port's ``experiment`` stopped as its second run starts, then
    resumed (``resume=True``: the latest run). Returns the records file's
    bytes after the interruption and the runs each call started."""
    from ab_line_classifier_torch.config import load_config

    cfg = load_config(path)
    real = E.perform_single_run
    started = []

    def stop_at_second(cfg, **kw):
        started.append(kw.get("fold_id", kw.get("hparam_overrides")))
        if len(started) == 2:
            raise Interrupted
        return real(cfg, **kw)

    monkeypatch.setattr(E, "perform_single_run", stop_at_second)
    with pytest.raises(Interrupted):
        E.train_experiment(cfg, experiment=experiment, verbose=False,
                           device="cpu")
    (records,) = glob.glob(os.path.join(cfg["PATHS"]["EXPERIMENTS"],
                                        "*.jsonl"))
    with open(records, "rb") as f:
        done = f.read()
    before = list(started)
    monkeypatch.setattr(E, "perform_single_run", real)
    resumed = []

    def count(cfg, **kw):
        resumed.append(kw.get("fold_id", kw.get("hparam_overrides")))
        return real(cfg, **kw)

    monkeypatch.setattr(E, "perform_single_run", count)
    out = E.train_experiment(cfg, experiment=experiment, verbose=False,
                             device="cpu", resume=True)
    return out, records, done, before, resumed


def outputs(path):
    with open(path) as f:
        d = yaml.safe_load(f)
    (records,) = glob.glob(os.path.join(d["PATHS"]["EXPERIMENTS"], "*.jsonl"))
    (summary,) = glob.glob(os.path.join(d["PATHS"]["EXPERIMENTS"], "*.csv"))
    with open(records) as f:
        recs = [json.loads(line) for line in f]
    return d, recs, summary


def assert_records_close(got, want):
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=RTOL, abs=1e-6), k
            else:
                assert g[k] == v, k


def assert_csv_close(got_path, want_path):
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape
    first = got.columns[0]
    assert list(got[first].astype(str)) == list(want[first].astype(str))
    np.testing.assert_allclose(got.iloc[:, 1:].to_numpy(float),
                               want.iloc[:, 1:].to_numpy(float), rtol=RTOL,
                               atol=1e-6)


def assert_writes_jax_csv(rows, want_path, tmp_path):
    out = str(tmp_path / "port.csv")
    E.write_csv(out, rows)
    with open(out, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()


def run_dirs(d):
    runs = []
    for run in sorted(glob.glob(os.path.join(d["TRACKER"]["DIR"], "*"))):
        with open(os.path.join(run, "events.jsonl")) as f:
            start = json.loads(f.readline())
        with open(os.path.join(run, "config.json")) as f:
            runs.append((start["group"], start["job_type"],
                         json.load(f)["FOLD_ID"]))
    return sorted(runs, key=lambda r: (r[2] is None, r[2]))


def test_folds_match_jax(workspace):
    """Each fold's train, val and test frames, through the array form."""
    from ab_line_classifier_tpu.config import load_config as jax_load
    from ab_line_classifier_tpu.train import experiment as JE
    from ab_line_classifier_torch.config import load_config

    path = config(workspace, "folds")
    source = E.source_from_kfold_tables(load_config(path))
    assert len(source.folds) == 3 and len(source.frames) == 48
    tables = JE.resolve_kfold_tables(jax_load(path))
    for fold_id in range(3):
        want = JE.resolve_datasets(jax_load(path), fold_id,
                                   kfold_tables=tables)[:3]
        for rows, w in zip(source.folds.fold(fold_id), want):
            assert [source.frames.frame_paths[i] for i in rows] == list(
                w["Frame Path"])
            np.testing.assert_array_equal(source.frames.labels[rows],
                                          w["Class"].to_numpy())


@pytest.mark.parametrize("kind", ["disk", "arrays"])
@pytest.mark.parametrize("limit_mb", [None, 0])
def test_fold_data_cached_within_the_run_budget(workspace, kind, limit_mb):
    """A run caches its fold's train and val sets on the device when the
    pair fits the run's budget, and otherwise serves them from the host
    (decoded from disk, or from host memory), whether the table is read
    from its JPEGs or given decoded; the batches are the same either
    way."""
    from ab_line_classifier_torch.config import load_config
    from ab_line_classifier_torch.data.pipeline import (DeviceCachedDataset,
                                                        FrameArrays)

    path = config(workspace, "cache")
    if limit_mb is not None:
        with open(path) as f:
            d = yaml.safe_load(f)
        d["TRAIN"].update(USE_MEMORY_LIMIT=True, MEMORY_LIMIT=limit_mb)
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
    cfg = load_config(path)
    source = E.source_from_kfold_tables(cfg)
    if kind == "arrays":
        disk = source.frames
        source = E.FoldSource(FrameArrays(*disk.load_all(), disk.frame_paths),
                              source.folds)
    want = source.fold(1)
    train_ds, val_ds, test = E._run_data(cfg, 1, source, "cpu")
    for got, w in zip((train_ds, val_ds, test), want):
        if got is not test:
            assert type(got) is (DeviceCachedDataset if limit_mb is None
                                 else type(w))
        assert list(got.frame_paths) == list(w.frame_paths)
        for g, b in zip(got.batches(8, shuffle=True, seed=2),
                        w.batches(8, shuffle=True, seed=2)):
            np.testing.assert_array_equal(np.asarray(g.images), b.images)
            np.testing.assert_array_equal(np.asarray(g.labels), b.labels)


def test_cross_validation_matches_jax(workspace, monkeypatch, tmp_path):
    from ab_line_classifier_torch.train.loop import Trainer

    jax_path = config(workspace, "kfold_jax")
    port_path = config(workspace, "kfold_port")
    run_jax(jax_path, "cross_validation")
    paths = []
    run_epoch = Trainer.run_epoch

    def recorded(trainer, *args, **kw):
        out = run_epoch(trainer, *args, **kw)
        paths.append(trainer.epoch_mode)
        return out

    monkeypatch.setattr(Trainer, "run_epoch", recorded)
    summary, records, done, before, resumed = run_port_interrupted(
        monkeypatch, port_path, "cross_validation")
    assert before == [0, 1] and resumed == [1, 2]
    # Every fold's cached data takes the graphed epoch runner (uncaptured
    # on the CPU), not the streamed per-step one.
    assert paths and set(paths) == {"uncaptured"}
    with open(records, "rb") as f:
        assert f.read().startswith(done) and done.count(b"\n") == 1

    jd, want, want_csv = outputs(jax_path)
    d, got, got_csv = outputs(port_path)
    assert_records_close(got, want)
    assert_csv_close(got_csv, want_csv)
    assert [r["fold"] for r in summary] == [0, 1, 2, "mean", "std"]
    assert_writes_jax_csv(want + E.mean_std_rows(want), want_csv, tmp_path)
    group = os.path.splitext(os.path.basename(records))[0]
    assert group.startswith("kfold-")
    got_runs, want_runs = run_dirs(d), run_dirs(jd)
    assert [r[1:] for r in got_runs] == [r[1:] for r in want_runs] == [
        ("single_train", i) for i in range(3)]
    assert {r[0] for r in got_runs} == {group}
    for name in ("test_roc", "test_cm"):
        assert len(glob.glob(os.path.join(d["PATHS"]["IMAGES"],
                                          f"{name}_*.png"))) >= 1


@pytest.mark.parametrize("method,n_evals", [("random", 3), ("bayes", 4)])
def test_hparam_search_matches_jax(workspace, monkeypatch, tmp_path, method,
                                   n_evals):
    jax_path = config(workspace, f"{method}_jax", METHOD=method,
                      N_EVALS=n_evals)
    port_path = config(workspace, f"{method}_port", METHOD=method,
                       N_EVALS=n_evals)
    want_out = run_jax(jax_path, "hparam_search")
    out, records, done, before, resumed = run_port_interrupted(
        monkeypatch, port_path, "hparam_search")
    assert len(before) == 2 and before[1] == resumed[0]
    assert len(resumed) == n_evals - 1
    with open(records, "rb") as f:
        assert f.read().startswith(done) and done.count(b"\n") == 1

    jd, want, want_csv = outputs(jax_path)
    d, got, got_csv = outputs(port_path)
    assert [{k: v for k, v in r.items() if k != "objective"} for r in got] \
        == [{k: v for k, v in r.items() if k != "objective"} for r in want]
    assert_records_close(got, want)
    assert_csv_close(got_csv, want_csv)
    assert_writes_jax_csv(want, want_csv, tmp_path)
    objectives = [r["objective"] for r in got]
    assert np.argsort(objectives).tolist() == np.argsort(
        [r["objective"] for r in want]).tolist()
    assert out["best_params"] == want_out["best_params"]
    assert out["best_objective"] == pytest.approx(want_out["best_objective"],
                                                  rel=RTOL)
    group = os.path.splitext(os.path.basename(records))[0]
    assert {r[0] for r in run_dirs(d)} == {group}
    plot = "bayes_opt" if method == "bayes" else "hparam_search"
    assert glob.glob(os.path.join(d["PATHS"]["EXPERIMENT_VISUALIZATIONS"],
                                  f"{plot}_*.png"))


def test_cli_runs_and_resumes_a_sweep(workspace):
    """``python -m ab_line_classifier_torch.train --experiment hparam_search
    --device cpu --sweep-id S``, then ``--resume``: the finished sweep is
    picked up, nothing reruns, and the records stay as they were."""
    path = config(workspace, "cli", N_EVALS=1)
    args = [sys.executable, "-m", "ab_line_classifier_torch.train",
            "--config", path, "--experiment", "hparam_search", "--device",
            "cpu", "--no-save-weights"]
    r = subprocess.run(args + ["--sweep-id", "sweep-cli"],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO_ROOT, env=cli_env(path))
    assert r.returncode == 0, r.stderr[-3000:]
    d, recs, _ = outputs(path)
    records = os.path.join(d["PATHS"]["EXPERIMENTS"], "sweep-cli.jsonl")
    with open(records, "rb") as f:
        done = f.read()
    assert len(recs) == 1
    r = subprocess.run(args + ["--resume"], capture_output=True, text=True,
                       timeout=600, cwd=REPO_ROOT, env=cli_env(path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resuming sweep sweep-cli: 1 trials done" in r.stdout
    assert "--- sweep trial" not in r.stdout
    with open(records, "rb") as f:
        assert f.read() == done


@pytest.mark.parametrize("content", [
    b'{"trial": 0, "objective": 1.0}\n{"trial": 1, "objective": 2.0}\n',
    b'{"trial": 0, "objective": 1.0}\n{"trial": 1, "obj',
    b'{"trial": 0, "objective": 1.0}\n{"trial": 1, "objective": 2.0}',
    b'{"trial": 0, "obj\n{"trial": 1, "objective": 2.0}\n', b''])
def test_trial_records_read_like_jax(tmp_path, content):
    """A trials file intact, torn in its last record, missing only its
    last newline, corrupt before its end, or empty: the same records, the
    same bytes left on disk, the same error."""
    from ab_line_classifier_tpu.train import experiment as JE

    outs = []
    for name, read in (("jax", JE._read_trial_records),
                       ("port", E._read_trial_records)):
        path = tmp_path / f"{name}.jsonl"
        path.write_bytes(content)
        try:
            outs.append((read(str(path), False), path.read_bytes()))
        except json.JSONDecodeError:
            outs.append(("raises", path.read_bytes()))
    assert outs[0] == outs[1]


def test_sweep_objective_like_jax(capsys):
    """The objective of a run by a val metric, a test metric, either goal,
    and a metric the run lacks (val AUC, maximized, and a notice)."""
    from ab_line_classifier_tpu.train import experiment as JE

    kw = dict(test_metrics={"f1": 0.25, "accuracy": 0.5},
              history=[], model_dir=None,
              best_val={"val_loss": 0.75, "val_auc": 0.625})
    got, want = E.RunResult(**kw), JE.RunResult(**kw)
    for name in ("epoch/val_loss", "epoch/val_auc", "test/f1", "accuracy",
                 "epoch/val_precision"):
        for goal in ("maximize", "minimize"):
            assert E._sweep_objective(got, name, goal) == \
                JE._sweep_objective(want, name, goal)
        assert E._extract_raw_metric(got, name) == \
            JE._extract_raw_metric(want, name)
    assert "scoring this trial by val_auc" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summary_csv_is_pandas_bytes(tmp_path, seed):
    """Fold rows of random metrics, a fold without AUCs (a one-class test
    set) and one fold alone: the port's summary CSV is, byte for byte,
    what the JAX package's pandas ``agg(["mean", "std"])`` + ``to_csv``
    writes."""
    rng = np.random.RandomState(seed)
    n_folds = (5, 3, 1)[seed]
    rows = []
    for fold in range(n_folds):
        row = {"fold": fold, "precision": float(rng.rand()),
               "accuracy": float(rng.randint(0, 4) / 4)}
        if fold != 1:
            row["macro_mean_auc"] = float(rng.rand() * 1e-3)
        rows.append(row)
    df = pd.DataFrame(rows)
    stats = df.drop(columns=["fold"]).agg(["mean", "std"])
    want = str(tmp_path / "pandas.csv")
    pd.concat([df, stats.reset_index().rename(columns={"index": "fold"})],
              ignore_index=True).to_csv(want, index=False)
    assert_writes_jax_csv(rows + E.mean_std_rows(rows), want, tmp_path)
