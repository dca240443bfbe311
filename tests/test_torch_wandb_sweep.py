"""PyTorch port, the W&B sweep backend (``train/wandb_sweep.py`` and
``hparam_search``'s ``BACKEND: wandb``) against the JAX package's.

Held exactly: ``wandb_sweep_config`` for every model section of
``config.yml`` and every parameter type; ``run_wandb_sweep`` with one
stand-in ``wandb`` module (``sweep`` / ``agent`` / ``init`` / ``log``; the
agent draws each trial's LR from the registered space with a seeded
``RandomState``) and a deterministic trial runner: the trials, ``best``,
``best_objective``, the values logged back to the service and the runner's
calls, for a maximized and a minimized metric and a metric the run lacks;
the warnings when attaching to a service sweep registered with another
metric and method; ``hparam_search``'s dispatch (``sweep_id`` passed on,
``--resume`` without one refused). Then ``hparam_search`` with ``BACKEND:
wandb`` trains real trials of a small cnn0 on the CPU in both packages
from the same Keras ``.h5``: the same LRs, objectives within 1e-4
relative (a few float32 steps, as ``test_torch_experiments.py``); without
wandb both run the native controller.
"""

import os
import sys
import types

import numpy as np
import pytest
import yaml

from conftest import REPO_ROOT, derive_workspace_config

from ab_line_classifier_tpu.config import Config as JaxConfig
from ab_line_classifier_tpu.config import load_config as jax_load_config
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.train import experiment as jax_experiment
from ab_line_classifier_tpu.train import wandb_sweep as jax_ws
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.train import experiment as E
from ab_line_classifier_torch.train import wandb_sweep as ws

RTOL = 1e-4
PACKAGES = (("jax", jax_ws, JaxConfig), ("port", ws, Config))


def config_dict():
    return jax_load_config(os.path.join(REPO_ROOT, "config.yml")).to_dict()


@pytest.mark.parametrize("model", sorted(config_dict()["HPARAM_SEARCH"]))
def test_sweep_config_equal_for_every_model(model):
    d = config_dict()
    search = d["TRAIN"]["HPARAM_SEARCH"]
    args = (search["METHOD"], search["METRIC_GOAL"], search["METRIC_NAME"],
            d["HPARAM_SEARCH"][model])
    got = ws.wandb_sweep_config(*args)
    assert got == jax_ws.wandb_sweep_config(*args)
    assert set(got["parameters"]) == {
        k for k, v in d["HPARAM_SEARCH"][model].items()
        if isinstance(v, dict) and v.get("RANGE") is not None}


def test_sweep_config_every_type_and_a_bad_one():
    search = {"LR": {"TYPE": "float_log", "RANGE": [1e-5, 1e-3]},
              "DROPOUT": {"TYPE": "float_uniform", "RANGE": [0.2, 0.5]},
              "BLOCKS": {"TYPE": "int_uniform", "RANGE": [1, 4]},
              "NODES": {"TYPE": "set", "RANGE": [16, 32, 64]},
              "UNUSED": {"TYPE": "set", "RANGE": None}}
    got = ws.wandb_sweep_config("bayes", "maximize", "epoch/val_auc", search)
    assert got == jax_ws.wandb_sweep_config("bayes", "maximize",
                                            "epoch/val_auc", search)
    assert got["parameters"]["LR"]["distribution"] == "log_uniform_values"
    for mod in (jax_ws, ws):
        with pytest.raises(ValueError, match="unknown sweep TYPE"):
            mod.wandb_sweep_config("bayes", "maximize", "m",
                                   {"X": {"TYPE": "bogus", "RANGE": [0, 1]}})


class StandInWandb(types.ModuleType):
    """``sweep`` / ``agent`` / ``init`` / ``log``; the agent samples LR
    log-uniformly from the registered space, as the service would."""

    def __init__(self):
        super().__init__("wandb")
        self.sweep_cfg, self.logged, self.calls = None, [], []
        self._config = None

    def sweep(self, sweep, project=None, entity=None):
        self.sweep_cfg = sweep
        self.calls.append(("sweep", project, entity))
        return "sweep-xyz"

    def init(self, *a, **k):
        config = self._config

        class Run:
            def __init__(self):
                self.config = config

            def finish(self):
                pass

        return Run()

    def log(self, payload):
        self.logged.append(payload)

    def agent(self, sweep_id, function, count=None):
        self.calls.append(("agent", sweep_id, count))
        rng = np.random.RandomState(0)
        if self.sweep_cfg is not None:
            lr = self.sweep_cfg["parameters"]["LR"]
            lo, hi = lr["min"], lr["max"]
        else:  # attached: the service owns the space
            lo, hi = 1e-5, 1e-3
        for _ in range(count):
            self._config = {
                "LR": float(np.exp(rng.uniform(np.log(lo), np.log(hi))))}
            function()


class Result:
    def __init__(self, best_val, test_metrics=None):
        self.best_val = best_val
        self.test_metrics = test_metrics or {}


def mobilenet_search(**search):
    d = config_dict()
    d["TRAIN"]["MODEL_DEF"] = "mobilenetv2"
    d["TRAIN"]["HPARAM_SEARCH"].update({"N_EVALS": 3, "METHOD": "bayes",
                                        "BACKEND": "wandb", **search})
    return d


@pytest.mark.parametrize("goal,metric,result", [
    ("maximize", "epoch/val_auc",
     lambda lr: {"val_auc": 0.5 + lr * 100, "val_loss": 0.7}),
    ("minimize", "epoch/val_loss",
     lambda lr: {"val_auc": 0.6, "val_loss": 0.9 - lr * 100}),
    ("minimize", "epoch/val_loss", lambda lr: {"val_auc": 0.5 + lr}),
    ("maximize", "test/accuracy", lambda lr: {"val_auc": 0.6}),
], ids=["max_auc", "min_loss", "missing_metric", "test_metric"])
def test_run_wandb_sweep_equal_to_jax(goal, metric, result):
    d = mobilenet_search(METRIC_GOAL=goal, METRIC_NAME=metric)
    out = {}
    for name, mod, config_cls in PACKAGES:
        stand_in, seen = StandInWandb(), []

        def run_fn(cfg, hparam_overrides=None, save_weights=False,
                   group=None, verbose=True):
            seen.append((dict(hparam_overrides), group, save_weights))
            lr = hparam_overrides["LR"]
            return Result(result(lr), {"accuracy": 1 - lr})

        res = mod.run_wandb_sweep(config_cls(d), wandb_module=stand_in,
                                  run_fn=run_fn, verbose=False)
        out[name] = (res, stand_in.logged, stand_in.calls,
                     stand_in.sweep_cfg, seen)
    assert out["port"] == out["jax"]
    res, logged, calls, _, seen = out["port"]
    assert len(res["trials"]) == 3 and res["sweep_id"] == "sweep-xyz"
    assert calls == [("sweep", d["WANDB"]["PROJECT_NAME"], None),
                     ("agent", "sweep-xyz", 3)]
    assert res["best_objective"] == max(t["objective"]
                                        for t in res["trials"])
    assert res["best_params"] == {"LR": res["best"]["LR"]}
    assert all(g == "sweep-xyz" for _, g, _ in seen)
    assert all(len(p) == 1 for p in logged)


def test_attach_to_a_service_sweep_warns_like_jax():
    d = mobilenet_search(N_EVALS=1, METRIC_GOAL="maximize",
                         METRIC_NAME="epoch/val_auc")

    class ApiSweep:
        config = {"metric": {"name": "epoch/val_loss", "goal": "minimize"},
                  "method": "grid"}

    messages = {}
    for name, mod, config_cls in PACKAGES:
        stand_in = StandInWandb()
        stand_in.Api = lambda: types.SimpleNamespace(
            sweep=lambda sweep_id: ApiSweep())
        with pytest.warns(UserWarning) as rec:
            res = mod.run_wandb_sweep(
                config_cls(d), wandb_module=stand_in, verbose=False,
                run_fn=lambda *a, **k: Result({"val_auc": 0.7}),
                sweep_id="svc-sweep")
        assert stand_in.sweep_cfg is None and res["sweep_id"] == "svc-sweep"
        messages[name] = [str(w.message) for w in rec]
    assert messages["port"] == messages["jax"]
    assert any("epoch/val_loss" in m for m in messages["port"])
    assert any("grid" in m for m in messages["port"])


def test_hparam_search_dispatch_like_jax(monkeypatch):
    d = mobilenet_search(N_EVALS=0)
    for name, fn, config_cls, kw in (
            ("jax", jax_experiment.hparam_search, JaxConfig, {}),
            ("port", E.hparam_search, Config, {"device": "cpu"})):
        stand_in = StandInWandb()
        monkeypatch.setitem(sys.modules, "wandb", stand_in)
        out = fn(config_cls(d), verbose=False, sweep_id="resume-me",
                 resume=True, **kw)
        assert stand_in.calls == [("agent", "resume-me", 0)], name
        assert out["sweep_id"] == "resume-me" and out["best_params"] is None
        with pytest.raises(ValueError, match="sweep-id"):
            fn(config_cls(d), verbose=False, resume=True, **kw)
        assert stand_in.calls == [("agent", "resume-me", 0)]


# -- real trials of a small cnn0 on the CPU ----------------------------------
@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    import jax

    from ab_line_classifier_tpu.models import build_model
    from ab_line_classifier_tpu.models.weights import export_h5_weights

    root = str(tmp_path_factory.mktemp("torch_wandb_sweep"))
    fcsv, ccsv, fdir = generate_dataset(root, n_patients=12,
                                        clips_per_patient=1,
                                        frames_per_clip=4, hw=(32, 32),
                                        seed=0)
    d = derive_workspace_config(root, fcsv, ccsv, fdir)
    d["TRAIN"].update({
        "MODEL_DEF": "cnn0", "EPOCHS": 1, "BATCH_SIZE": 8,
        "MIXED_PRECISION": False, "USE_PRETRAINED": True, "DATA_AUG": {}})
    d["TRAIN"]["HPARAM_SEARCH"].update({
        "N_EVALS": 2, "METHOD": "bayes", "METRIC_NAME": "epoch/val_loss",
        "METRIC_GOAL": "minimize", "BACKEND": "wandb"})
    d["HPARAMS"]["CNN0"].update({"DROPOUT": 0.0, "BLOCKS": 2,
                                 "INIT_FILTERS": 8, "NODES_DENSE0": 16})
    d["HPARAM_SEARCH"]["CNN0"] = {
        "LR": {"TYPE": "float_log", "RANGE": [1e-4, 1e-3]}}
    spec = build_model("cnn0", d["HPARAMS"]["CNN0"], (32, 32, 3), 2)
    h5 = os.path.join(root, "pretrained.h5")
    export_h5_weights(h5, spec.init_variables(jax.random.PRNGKey(3)),
                      graph=spec.graph)
    d["PATHS"]["PRETRAINED_WEIGHTS"] = h5
    return root, d


def outputs_under(d, root):
    d = yaml.safe_load(yaml.safe_dump(d))
    for key in ("EXPERIMENTS", "IMAGES", "MODEL_WEIGHTS",
                "EXPERIMENT_VISUALIZATIONS"):
        d["PATHS"][key] = os.path.join(root, key.lower())
    d["TRACKER"]["DIR"] = os.path.join(root, "runs")
    return d


def test_hparam_search_trains_wandb_trials_like_jax(workspace, monkeypatch):
    root, d = workspace
    out = {}
    for name, fn, config_cls, kw in (
            ("jax", jax_experiment.hparam_search, JaxConfig, {}),
            ("port", E.hparam_search, Config, {"device": "cpu"})):
        stand_in = StandInWandb()
        monkeypatch.setitem(sys.modules, "wandb", stand_in)
        res = fn(config_cls(outputs_under(d, os.path.join(root, name))),
                 verbose=False, **kw)
        out[name] = (res, stand_in.logged)
    (port, port_logged), (jax_res, jax_logged) = out["port"], out["jax"]
    assert len(port["trials"]) == 2
    for p, j in zip(port["trials"], jax_res["trials"]):
        assert p["LR"] == j["LR"]
        np.testing.assert_allclose(p["objective"], j["objective"], rtol=RTOL)
    for p, j in zip(port_logged, jax_logged):
        assert list(p) == list(j) == ["epoch/val_loss"]
        np.testing.assert_allclose(p["epoch/val_loss"], j["epoch/val_loss"],
                                   rtol=RTOL)
        assert p["epoch/val_loss"] > 0
    assert port["best_params"] == jax_res["best_params"]
    # the runs are grouped under the service's sweep id
    runs = os.listdir(os.path.join(root, "port", "runs"))
    assert len(runs) == 2


def test_hparam_search_without_wandb_runs_natively(workspace, monkeypatch,
                                                   capsys):
    root, d = workspace
    monkeypatch.setitem(sys.modules, "wandb", None)
    d = outputs_under(d, os.path.join(root, "native"))
    d["TRAIN"]["HPARAM_SEARCH"]["N_EVALS"] = 1
    out = E.hparam_search(Config(d), verbose=False, device="cpu")
    assert "wandb sweep backend unavailable" in capsys.readouterr().out
    assert out["best_params"] is not None and len(out["trials"]) == 1
    assert "sweep_id" not in out
