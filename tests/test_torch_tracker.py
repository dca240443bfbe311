"""PyTorch port, experiment trackers (``train/tracker.py``) against the JAX
package's.

One stand-in ``wandb`` module (``init`` / ``log`` / ``Image``, a run with
``config.update``, ``summary`` and ``finish``) records every call; the
same sequence of epoch logs, metrics, an image and a final summary, given
to both packages' ``WandbTracker``, records identical calls. Both
``TensorBoardTracker``s write event files whose scalars read back equal
through tensorboard's ``EventAccumulator``, and equal to the port's
``LocalTracker`` event log of the same sequence. ``make_tracker`` selects
each backend in both packages, and where the backend does not import,
both say so and track locally.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest

from ab_line_classifier_tpu.train import loop as jax_loop
from ab_line_classifier_tpu.train import tracker as jax_tracker
from ab_line_classifier_torch.train import loop
from ab_line_classifier_torch.train import tracker

LOGS = [
    dict(epoch=0, phase="extract", train={"loss": 0.91, "auc": 0.5},
         val={"loss": 1.02, "auc": 0.61}, lr=1e-3, seconds=0.5),
    dict(epoch=1, phase="extract", train={"loss": 0.72, "auc": 0.66},
         val={"loss": 0.95, "auc": 0.64}, lr=5e-4, seconds=0.4),
    dict(epoch=2, phase="finetune", train={"loss": 0.51, "auc": 0.8},
         val={}, lr=None, seconds=0.4),
]
METRICS = {"accuracy": 0.75, "macro_mean_auc": 0.5, "note": "text"}


class _Config(dict):
    def __init__(self, calls):
        super().__init__()
        self._calls = calls

    def update(self, values, allow_val_change=False):
        self._calls.append(("config.update", dict(values), allow_val_change))


class _Summary(dict):
    def __init__(self, calls):
        super().__init__()
        self._calls = calls

    def __setitem__(self, k, v):
        self._calls.append(("summary", k, v))


class StandInWandb:
    """The surface the trackers touch; every call lands in ``calls``."""

    def __init__(self, root):
        self.root = root
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))
        calls = self.calls

        class Run:
            dir = self.root
            config = _Config(calls)
            summary = _Summary(calls)

            def finish(self):
                calls.append(("finish",))

        return Run()

    def log(self, payload, step=None):
        self.calls.append(("log", {k: (v.array.tolist()
                                       if isinstance(v, self.Image) else v)
                                   for k, v in payload.items()}, step))

    class Image:
        def __init__(self, array):
            self.array = np.asarray(array)


def drive(t, epoch_log_cls):
    t.log_config({"HPARAMS": {"LR": 1e-3}, "FOLD_ID": None})
    for kw in LOGS:
        t.log_epoch(epoch_log_cls(**kw))
    t.log_metrics("test", METRICS)
    t.log_image("test_cm", np.arange(4 * 6 * 3, dtype=np.uint8).reshape(
        4, 6, 3), step=2)
    t.finish({"status": "ok", "val_loss": 0.95})


def test_wandb_trackers_make_identical_calls(tmp_path, monkeypatch):
    calls = {}
    for name, mod, logs in (("jax", jax_tracker, jax_loop),
                            ("port", tracker, loop)):
        stand_in = StandInWandb(str(tmp_path))
        monkeypatch.setitem(sys.modules, "wandb", stand_in)
        t = mod.WandbTracker(project="ab_line", entity="team", group="g1",
                             job_type="hparam_search")
        assert t.run_dir == str(tmp_path)
        drive(t, logs.EpochLog)
        calls[name] = stand_in.calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", {
        "project": "ab_line", "entity": "team", "group": "g1",
        "job_type": "hparam_search", "config": None})
    keys = [sorted(c[1]) for c in calls["port"] if c[0] == "log"]
    assert keys[0] == ["epoch/auc", "epoch/loss", "epoch/lr",
                       "epoch/val_auc", "epoch/val_loss"]
    assert keys[3] == [f"test/{k}" for k in sorted(METRICS)]


def test_wandb_tracker_takes_a_module_argument(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import would raise
    stand_in = StandInWandb(str(tmp_path))
    drive(tracker.WandbTracker(project="p", wandb_module=stand_in),
          loop.EpochLog)
    assert stand_in.calls[-1] == ("finish",)


def scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(run_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_trackers_write_equal_scalars(tmp_path):
    runs = {}
    for name, mod, logs in (("jax", jax_tracker, jax_loop),
                            ("port", tracker, loop)):
        t = mod.TensorBoardTracker(str(tmp_path / name), run_name="tb")
        assert t.run_dir == str(tmp_path / name / "tb")
        drive(t, logs.EpochLog)
        assert glob.glob(os.path.join(t.run_dir, "events.out.tfevents.*"))
        runs[name] = scalars(t.run_dir)
    assert runs["port"] == runs["jax"]
    local = tracker.LocalTracker(str(tmp_path / "local"), run_name="lt")
    drive(local, loop.EpochLog)
    with open(os.path.join(local.run_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    want = {}
    for e in events:
        if e["event"] != "epoch":
            continue
        for k, v in e.items():
            if k.startswith(("train/", "val/")):
                split, metric = k.split("/", 1)
                tag = (f"epoch/{metric}" if split == "train"
                       else f"epoch/val_{metric}")
                want.setdefault(tag, []).append((e["epoch"], v))
        if e["lr"] is not None:
            want.setdefault("epoch/lr", []).append((e["epoch"], e["lr"]))
    got = {k: v for k, v in runs["port"].items() if k.startswith("epoch/")}
    assert sorted(got) == sorted(want)
    for tag in want:  # event files keep float32
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in want[tag]], rtol=1e-7)
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
    assert sorted(k for k in runs["port"] if k.startswith("test/")) == [
        "test/accuracy", "test/macro_mean_auc"]


@pytest.mark.parametrize("backend", ["wandb", "tensorboard", "local",
                                     "none"])
def test_make_tracker_selects_like_jax(tmp_path, monkeypatch, capsys,
                                       backend):
    stand_in = StandInWandb(str(tmp_path))
    monkeypatch.setitem(sys.modules, "wandb", stand_in)
    cfg = {"TRACKER": {"BACKEND": backend, "DIR": str(tmp_path / "runs")},
           "PATHS": {"LOGS": str(tmp_path / "logs")},
           "WANDB": {"PROJECT_NAME": "ab_line", "ENTITY": ""}}
    names = []
    for mod in (jax_tracker, tracker):
        t = mod.make_tracker(cfg, group="g", job_type="train")
        names.append(type(t).__name__)
        t.finish()
    assert names[0] == names[1] == {
        "wandb": "WandbTracker", "tensorboard": "TensorBoardTracker",
        "local": "LocalTracker", "none": "NullTracker"}[backend]
    if backend == "wandb":
        inits = [c for c in stand_in.calls if c[0] == "init"]
        assert inits[0] == inits[1] and inits[0][1]["entity"] is None


@pytest.mark.parametrize("backend", ["wandb", "tensorboard"])
def test_unimportable_backend_falls_back_to_local(tmp_path, monkeypatch,
                                                  capsys, backend):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = {"TRACKER": {"BACKEND": backend, "DIR": str(tmp_path / "runs")},
           "PATHS": {"LOGS": str(tmp_path / "logs")},
           "WANDB": {"PROJECT_NAME": "ab_line"}}
    said = []
    for mod in (jax_tracker, tracker):
        t = mod.make_tracker(cfg)
        assert isinstance(t, mod.LocalTracker)
        t.finish()
        said.append(capsys.readouterr().out)
    assert said[0] == said[1]
    assert f"{backend} tracker unavailable" in said[1]
    assert "falling back to local" in said[1]
