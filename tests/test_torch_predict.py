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


def test_gradcam_and_latency_benchmarks_run_on_cpu():
    """``gradcam_benchmark``, the batch-1 latency chain (eager only: CUDA
    graphs exist on the card) and ``clock_avg_runtime`` on the CPU; the
    profiling module's step timer discards its warm-up steps."""
    from ab_line_classifier_torch.predict.benchmark import (
        build_flagship, clock_avg_runtime, gradcam_benchmark, seeded_state,
        single_frame_latency_benchmark)
    from ab_line_classifier_torch.utils.profiling import StepTimer

    for mode in ("normal", "plusplus"):
        r = gradcam_benchmark(batch_size=2, img_dim=(32, 32), mode=mode,
                              n_warmup=1, n_iters=1, device="cpu",
                              verbose=False)
        assert r["mode"] == mode and r["gradcam_frames_per_sec"] > 0
    r = single_frame_latency_benchmark(img_dim=(32, 32), chain_len=2,
                                       n_warmup=1, n_iters=1, device="cpu",
                                       verbose=False)
    assert r["eager_ms_per_frame"] > 0 and r["graph_ms_per_frame"] is None
    # The chain's output on its check frames is the serving forward's: the
    # offset it adds between steps is always zero.
    spec = build_flagship((32, 32))
    want = Predictor(spec, seeded_state(spec), device="cpu").forward(
        torch.as_tensor(r["check_frames"]))
    assert r["check_frames"].shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(r["check_probs"], want.numpy())
    mean_ms, std_ms = clock_avg_runtime(1, 3, img_dim=(32, 32),
                                        device="cpu", verbose=False)
    assert mean_ms > 0 and std_ms >= 0
    timer = StepTimer(warmup=2)
    for _ in range(5):
        with timer:
            pass
    assert timer.summary()["steps"] == 3


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


def _file_checkpoint(ws, cfgs, ext):
    """The workspace's weights as a ``.h5`` (JAX ``export_h5_weights``) or
    ``.onnx`` (JAX ``export_onnx``) file, and the port's and the JAX
    package's configs serving it."""
    from ab_line_classifier_tpu.models.onnx_export import export_onnx
    from ab_line_classifier_tpu.models.weights import export_h5_weights
    from ab_line_classifier_torch.utils.jax_params import flax_from_state_dict

    state, _ = torch_ckpt.load_model(os.path.join(ws, "torch_models",
                                                  "latest"))
    variables = flax_from_state_dict(state)
    cfg = load_config(cfgs["torch"])
    path = os.path.join(ws, f"weights.{ext}")
    if not os.path.exists(path):
        if ext == "h5":
            export_h5_weights(path, variables)
        else:
            spec = jax_build_model(cfg.model_name, cfg.model_hparams(),
                                   cfg.img_dim + (3,), cfg.n_classes)
            export_onnx(spec, variables, path, batch_size=2)
    d = cfg.to_dict()
    d["PATHS"]["MODEL_TO_LOAD"] = path
    return path, d, state


@pytest.mark.parametrize("ext", ["h5", "onnx"])
def test_restore_file_matches_jax(workspace, ext):
    """``Predictor.restore(cfg=)`` of a JAX-written ``.h5`` / ``.onnx``:
    float32, the weights of the port checkpoint bit for bit, and the JAX
    package's restore of the same file within 1e-4."""
    from ab_line_classifier_tpu.config import Config as JaxConfig
    from ab_line_classifier_tpu.predict.predict import (
        Predictor as JaxPredictor)
    from ab_line_classifier_torch.config import Config

    ws, cfgs = workspace
    path, d, state = _file_checkpoint(ws, cfgs, ext)
    got = Predictor.restore(path, cfg=Config(d), batch_size=4,
                            compute_dtype=torch.float32, device="cpu")
    assert got.spec.dtype == torch.float32
    for k, v in got.module.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    import jax.numpy as jnp

    want = JaxPredictor.restore(path, cfg=JaxConfig(d), batch_size=4,
                                compute_dtype=jnp.float32)
    frames = np.random.RandomState(5).randint(
        0, 256, (6, 40, 48, 3)).astype(np.uint8)
    np.testing.assert_allclose(got.predict_probs(frames),
                               want.predict_probs(frames), atol=PROB_ATOL)


def test_restore_file_needs_cfg_and_a_match(workspace, tmp_path):
    from ab_line_classifier_torch.config import Config
    import h5py

    ws, cfgs = workspace
    path, d, _ = _file_checkpoint(ws, cfgs, "h5")
    with pytest.raises(ValueError, match="needs cfg"):
        Predictor.restore(path, device="cpu")
    other = str(tmp_path / "other.h5")
    with h5py.File(other, "w") as f:
        g = f.create_group("model_weights").create_group("unrelated")
        g.create_group("unrelated").create_dataset(
            "kernel:0", data=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="no layers matched"):
        Predictor.restore(other, cfg=Config(d), device="cpu")


def test_cli_serves_h5_with_profile(workspace):
    """The predict CLI on ``PATHS.MODEL_TO_LOAD`` = a ``.h5``: the frames
    CSV holds what the port checkpoint's weights give (the CLI's bf16
    preprocess, float32 model), and ``--profile`` writes a trace."""
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.data.pipeline import FrameDataset

    ws, cfgs = workspace
    _, d, state = _file_checkpoint(ws, cfgs, "h5")
    d["PATHS"].update({
        "BATCH_PREDS": os.path.join(ws, "h5_predictions") + os.sep,
        "METRICS": os.path.join(ws, "h5_metrics") + os.sep,
        "LOGS": os.path.join(ws, "h5_logs") + os.sep})
    cfg_path = _write_cfg(os.path.join(ws, "h5_config.yml"), d)
    r = subprocess.run(
        [sys.executable, "-m", "ab_line_classifier_torch.predict",
         "--config", cfg_path, "--device", "cpu", "--profile"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
        env=cli_env(cfg_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "profiler trace written to" in r.stdout
    trace, = glob.glob(os.path.join(ws, "h5_logs", "profiles", "*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"predict.preprocess", "predict.model"} <= names
    csvs, _ = _outputs(ws, "h5")
    cfg = Config(d)
    spec = build_model(cfg.model_name, cfg.model_hparams(),
                       cfg.img_dim + (3,), cfg.n_classes)
    frames_df = pd.read_csv(d["PATHS"]["FRAME_TABLE"])
    want = Predictor(spec, state, batch_size=cfg.batch_size,
                     device="cpu").predict_dataset(
        FrameDataset(frames_df, d["PATHS"]["FRAMES"], img_dim=cfg.img_dim))
    got = csvs["frames_frames"]
    np.testing.assert_allclose(got[["a_lines", "b_lines"]].to_numpy(), want,
                               rtol=0, atol=1e-6)
