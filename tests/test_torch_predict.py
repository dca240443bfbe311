"""PyTorch port, serving CLI: ``python -m ab_line_classifier_torch.predict
--device cpu`` against the JAX package's predict CLI on one synthetic
workspace, with the same weights (a float32 checkpoint saved by each
package's own checkpoint module, the port's through the weight bridge).

Both CLIs must write the same prediction CSVs (same columns, same rows,
probabilities within 1e-4) and metrics JSONs with the same keys. The port's
checkpoint contract and its no-silent-CPU rule are checked here too.
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
from test_torch_model import serving_variables

from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.predict.__main__ import main as jax_predict_main
from ab_line_classifier_tpu.utils import checkpoint as jax_ckpt
from ab_line_classifier_torch.predict.benchmark import (
    clip_inference_benchmark)
from ab_line_classifier_torch.predict.predict import (Predictor,
                                                      default_predictor)
from ab_line_classifier_torch.config import load_config
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

PROB_ATOL = 1e-4


def _write_cfg(path, d):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("torch_predict"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=4, clips_per_patient=2,
                                        frames_per_clip=4, hw=(32, 32),
                                        seed=0)
    d = derive_workspace_config(ws, fcsv, ccsv, fdir)
    hparams = d["HPARAMS"]["CUTOFFVGG16"]
    variables = serving_variables(
        jax_build_model("cutoffvgg16", hparams, (32, 32, 3), 2))
    meta = {"model_name": "cutoffvgg16", "hparams": hparams,
            "input_shape": [32, 32, 3], "n_classes": 2,
            "classes": d["DATA"]["CLASSES"], "preprocess_mode": "caffe",
            "mixed_precision": False}
    jax_ckpt.save_model(os.path.join(ws, "jax_models", "model1"), variables,
                        meta)
    torch_ckpt.save_model(os.path.join(ws, "torch_models", "model1"),
                          state_dict_from_flax(variables), meta)
    cfgs = {}
    for side in ("jax", "torch"):
        d["PATHS"].update({
            "MODEL_TO_LOAD": os.path.join(ws, f"{side}_models", "latest"),
            "BATCH_PREDS": os.path.join(ws, f"{side}_predictions") + os.sep,
            "METRICS": os.path.join(ws, f"{side}_metrics") + os.sep})
        cfgs[side] = _write_cfg(os.path.join(ws, f"{side}_config.yml"), d)
    return ws, cfgs


def _outputs(ws, side):
    csvs = {os.path.basename(p).split("_predictions")[0]: pd.read_csv(p)
            for p in glob.glob(os.path.join(ws, f"{side}_predictions",
                                            "*.csv"))}
    metrics = {}
    for p in glob.glob(os.path.join(ws, f"{side}_metrics", "*.json")):
        with open(p) as f:
            metrics[os.path.basename(p)[:6]] = json.load(f)
    return csvs, metrics


def test_cli_matches_jax(workspace, monkeypatch):
    ws, cfgs = workspace
    monkeypatch.setattr(sys, "argv", ["predict", "--config", cfgs["jax"]])
    jax_predict_main()
    r = subprocess.run(
        [sys.executable, "-m", "ab_line_classifier_torch.predict",
         "--config", cfgs["torch"], "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=cli_env(cfgs["torch"]))
    assert r.returncode == 0, r.stderr[-2000:]

    want_csvs, want_metrics = _outputs(ws, "jax")
    got_csvs, got_metrics = _outputs(ws, "torch")
    assert set(want_csvs) == {"frames_clips", "frames_frames"}
    assert set(got_csvs) == set(want_csvs)
    classes = ["a_lines", "b_lines"]
    for name, want in want_csvs.items():
        got = got_csvs[name]
        assert list(got.columns) == list(want.columns), name
        rest = [c for c in want.columns if c not in classes]
        pd.testing.assert_frame_equal(got[rest], want[rest])
        np.testing.assert_allclose(got[classes].to_numpy(),
                                   want[classes].to_numpy(), atol=PROB_ATOL)
    assert set(got_metrics) == set(want_metrics) == {"clips_", "frames"}
    for k in want_metrics:
        assert set(got_metrics[k]) == set(want_metrics[k]), k


def test_no_silent_cpu_fallback(workspace):
    """Without CUDA, an entry point that was not asked for the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    _, cfgs = workspace
    cfg = load_config(cfgs["torch"])
    spec = build_model("cutoffvgg16", cfg.model_hparams(), (32, 32, 3), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(spec, spec.module().state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_predictor(cfg)
    assert default_predictor(cfg, "cpu").device.type == "cpu"


def test_benchmark_runs_on_cpu_when_asked():
    """The serving benchmark drives the Predictor forward and counts FLOPs
    from layer shapes: cutoffvgg16's seven 3x3 convs plus the Dense head."""
    r = clip_inference_benchmark(batch_size=2, img_dim=(32, 32),
                                 n_warmup=1, n_iters=1, device="cpu",
                                 verbose=False)
    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256), (8, 256, 256)]
    want = sum(2 * hw * hw * cin * cout * 9 for hw, cin, cout in convs)
    assert r["flops_per_frame"] == want + 2 * 256 * 2
    assert r["device"] == "cpu" and r["frames_per_sec"] > 0


def test_checkpoint_contract(tmp_path):
    """state.pt + meta.json (meta last) round trip; a directory of
    checkpoints and ``.../latest`` resolve to the newest complete one."""
    spec = build_model("cutoffvgg16", {"DROPOUT": 0.45}, (32, 32, 3), 2)
    sd = spec.module(generator=torch.Generator().manual_seed(4)).state_dict()
    root = tmp_path / "models"
    old = torch_ckpt.save_model(str(root / "model1"), sd, {"n_classes": 2})
    new = torch_ckpt.save_model(str(root / "model2"), sd, {"n_classes": 2})
    os.utime(old, (1, 1))
    (root / "model3").mkdir()  # an interrupted save: no meta.json
    (root / "model3" / "state.pt").write_bytes(b"")
    assert torch_ckpt.resolve_model_dir(str(root)) == new
    assert torch_ckpt.resolve_model_dir(str(root / "latest")) == new
    state, meta = torch_ckpt.load_model(str(root / "latest"))
    assert meta == {"n_classes": 2}
    for k, v in sd.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        torch_ckpt.resolve_model_dir(str(tmp_path / "nothing"))
