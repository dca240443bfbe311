"""PyTorch port, Grad-CAM: ``explain/gradcam.py`` and the explain CLI
against the JAX package's ``GradCAMExplainer``.

The same numpy-seeded frames and the same weights (randomized leaves,
scaled and batch-norm-calibrated as in ``tests/test_torch_model.py`` and
``tests/test_torch_zoo.py``, carried across by the weight bridge) go
through both packages in float32: cutoffvgg16, cnn0 and mobilenetv2 at
32x32, xception at 64x64 (at 32x32 its tap is a single pixel).

Tolerances: probabilities within 1e-5 (float32 forwards that sum in
different orders differ by a few float32 ulps of the logits), heatmaps
within 1e-4 absolute (they are normalized to [0, 1]; the gradient at the
tap carries the forward's rounding once more). The Grad-CAM++ weighting
is pinned by a closed-form per-frame oracle, as in
``tests/test_gradcam.py``.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import REPO_ROOT, cli_env, derive_workspace_config
from test_torch_model import serving_variables as vgg_variables
from test_torch_zoo import (HPARAMS as ZOO_HP, PREPROCESS, port_spec,
                            serving_variables as zoo_variables)

from ab_line_classifier_tpu.config import Config as JaxConfig
from ab_line_classifier_tpu.config import load_config as jax_load_config
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_tpu.explain import gradcam as jax_gradcam
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.explain import gradcam
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.ops.image import (
    fused_preprocess as port_preprocess)
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.predict.predict import load_module
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

PROB_ATOL = 1e-5
CAM_ATOL = 1e-4
VGG_HP = {"DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7}
SIZE = {"cutoffvgg16": 32, "cnn0": 32, "mobilenetv2": 32, "xception": 64}
CPU = torch.device("cpu")


def _frames(n, size, seed=3):
    return np.random.RandomState(seed).randint(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _config(size, model_name):
    d = jax_load_config(os.path.join(REPO_ROOT, "config.yml")).to_dict()
    d["DATA"]["IMG_DIM"] = [size, size]
    d["TRAIN"]["MODEL_DEF"] = model_name
    return d


def _models(name):
    """(JAX spec, port spec, JAX variables) in float32 at SIZE[name]."""
    shape = (SIZE[name],) * 2 + (3,)
    if name == "cutoffvgg16":
        jax_spec = jax_build_model(name, VGG_HP, shape, 2)
        return (jax_spec, build_model(name, VGG_HP, shape, 2),
                vgg_variables(jax_spec))
    inputs = np.array(fused_preprocess(
        jnp.asarray(_frames(16, shape[0])), out_hw=shape[:2],
        preprocess_mode=PREPROCESS[name]))
    return (jax_build_model(name, ZOO_HP[name], shape, 2),
            port_spec(name, shape=shape), zoo_variables(name, inputs))


@pytest.fixture(scope="module", params=list(SIZE))
def pair(request):
    return request.param, _models(request.param)


@pytest.mark.parametrize("mode", ["normal", "plusplus"])
def test_explain_frames_matches_jax(pair, mode):
    name, (jax_spec, spec, variables) = pair
    d = _config(SIZE[name], name)
    frames = _frames(6, SIZE[name], seed=7)
    want_p, want_c = jax_gradcam.GradCAMExplainer(
        JaxConfig(d), spec=jax_spec, variables=variables,
        mode=mode).explain_frames(frames)
    explainer = gradcam.GradCAMExplainer(
        Config(d), spec=spec, state_dict=state_dict_from_flax(variables),
        mode=mode, device="cpu")
    assert explainer.conv_layer == jax_spec.last_conv_layer
    got_p, got_c = explainer.explain_frames(frames)
    assert got_p.dtype == got_c.dtype == np.float32
    assert got_c.shape == (6, SIZE[name], SIZE[name])
    want_c = np.asarray(want_c, np.float32)
    # A frame whose weighted sum is negative everywhere has an empty
    # heatmap (ReLU); most must not be.
    assert (want_c.max(axis=(1, 2)) > 0.5).sum() >= 4, "heatmaps are empty"
    assert np.ptp(want_p[:, 1]) > 1e-3, "the probabilities are flat"
    np.testing.assert_allclose(got_p, want_p, atol=PROB_ATOL)
    np.testing.assert_allclose(got_c, want_c, atol=CAM_ATOL)


@pytest.mark.parametrize("name", list(ZOO_HPARAMS))
def test_tap_matches_jax(name):
    """The last-conv tap of every zoo model, by graph (no init)."""
    shape = (128, 128, 3)
    want = jax_build_model(name, ZOO_HPARAMS[name], shape, 2).last_conv_layer
    assert build_model(name, ZOO_HPARAMS[name], shape,
                       2).last_conv_layer == want


CNN0_HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 0.0, "NODES_DENSE0": 8,
           "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
           "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}


def test_plusplus_matches_closed_form_oracle():
    """Grad-CAM++ (Chattopadhay et al. 2018, eq. 19): alpha = g^2 / (2 g^2
    + sum_ab A_ab g^3), w_k = sum_ij alpha_ij relu(g_ij), with g taken
    frame by frame through the head by ``overrides`` (independently of the
    batched leaf pass), on cnn0 as the JAX package's oracle test."""
    spec = build_model("cnn0", CNN0_HP, (32, 32, 3), 2)
    sd = spec.module(generator=torch.Generator().manual_seed(5)).state_dict()
    module = load_module(spec, sd, CPU)
    frames = torch.as_tensor(_frames(3, 32, seed=4))
    probs, cams = gradcam.build_fused_gradcam(spec, module, "plusplus")(
        frames)
    tap = spec.last_conv_layer
    x = port_preprocess(frames, out_hw=spec.input_shape[:2],
                        preprocess_mode=spec.preprocess_mode)
    head = spec.module(capture=(tap,))
    head.load_state_dict(sd)
    head.eval().requires_grad_(False)
    with torch.no_grad():
        _, caps = head(x)
    oracle = []
    for i in range(len(frames)):
        a_i = caps[tap][i].clone().requires_grad_()
        out, _ = head(x[i:i + 1], overrides={tap: a_i[None]})
        g, = torch.autograd.grad(out[0, int(probs[i].argmax())], a_i)
        a_i = a_i.detach()
        g2, g3 = g * g, g * g * g
        denom = 2.0 * g2 + (a_i * g3).sum(dim=(0, 1), keepdim=True)
        alpha = torch.where(denom.abs() > 1e-12, g2 / denom,
                            torch.zeros_like(g2))
        w = (alpha * torch.relu(g)).sum(dim=(0, 1))
        cam = torch.relu(torch.einsum("hwc,c->hw", a_i, w))
        cam = cam / torch.clamp(cam.max(), min=1e-12)
        oracle.append(torch.nn.functional.interpolate(
            cam[None, None], size=(32, 32), mode="bilinear",
            align_corners=False)[0, 0])
    assert all(c.max() > 0.5 for c in oracle)
    np.testing.assert_allclose(cams.numpy(), torch.stack(oracle).numpy(),
                               atol=1e-5)


def test_colormap_and_overlay_equal_jax():
    rng = np.random.RandomState(0)
    heat = np.concatenate([rng.uniform(-0.2, 1.2, 500),
                           gradcam.JET_POS, [0.0, 1.0]]).astype(np.float32)
    np.testing.assert_array_equal(gradcam.jet_colormap(heat),
                                  jax_gradcam.jet_colormap(heat))
    orig = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    cam = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    for intensity in (0.5, 0.3):
        np.testing.assert_array_equal(
            gradcam.heatmap_overlay(orig, cam, intensity),
            jax_gradcam.heatmap_overlay(orig, cam, intensity))


def test_each_node_runs_once_per_batch():
    """mobilenetv2 (its tap ``block_12_project`` feeds ``block_12_add``,
    whose other input comes from before the tap): every node of the graph,
    module or function, runs exactly once per Grad-CAM batch, and the
    backbone before the tap is not recorded by autograd."""
    spec = build_model("mobilenetv2", ZOO_HPARAMS["mobilenetv2"],
                       (32, 32, 3), 2)
    calls = {}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapper

    graph = G.LayerGraph(
        layers=tuple(dataclasses.replace(s, fn=counted(s.name, s.fn))
                     if s.fn is not None and s.name != G.INPUT else s
                     for s in spec.graph.layers),
        output=spec.graph.output)
    spec = dataclasses.replace(spec, graph=graph)
    module = load_module(spec, spec.module().state_dict(), CPU)
    recorded = []
    for s in graph.layers[1:]:
        if s.module_fn is not None:
            def hook(mod, args, out, name=s.name):
                calls[name] = calls.get(name, 0) + 1
                recorded.append((name, out.requires_grad))
            module.get_submodule(s.name).register_forward_hook(hook)
    fused = gradcam.build_fused_gradcam(spec, module, "plusplus")
    fused(torch.as_tensor(_frames(2, 32)))
    assert calls == {s.name: 1 for s in graph.layers[1:]}
    grad_after = [name for name, req in recorded if req]
    tap = graph.index_of(spec.last_conv_layer)
    assert all(graph.index_of(n) > tap for n in grad_after)
    assert "block_12_project_BN" in grad_after


def test_explain_cli_writes_a_png_per_frame(tmp_path):
    """``python -m ab_line_classifier_torch.explain --device cpu`` on a
    synthetic frames table and a port checkpoint: one heatmap PNG per
    frame, ``--frames`` matched by file name, ``--profile`` writes a
    trace."""
    ws = str(tmp_path)
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=2, clips_per_patient=1,
                                        frames_per_clip=3, hw=(32, 32),
                                        seed=0)
    d = derive_workspace_config(ws, fcsv, ccsv, fdir)
    d["TRAIN"]["MODEL_DEF"] = "cnn0"
    d["HPARAMS"]["CNN0"] = dict(CNN0_HP)
    spec = build_model("cnn0", CNN0_HP, (32, 32, 3), 2)
    torch_ckpt.save_model(
        os.path.join(ws, "results", "models", "model1"),
        spec.module(generator=torch.Generator().manual_seed(1)).state_dict(),
        {"model_name": "cnn0", "hparams": CNN0_HP, "input_shape": [32, 32, 3],
         "n_classes": 2, "mixed_precision": False})
    cfg = os.path.join(ws, "config.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(d, f)

    def run(*args):
        r = subprocess.run(
            [sys.executable, "-m", "ab_line_classifier_torch.explain",
             "--config", cfg, "--device", "cpu", *args],
            capture_output=True, text=True, timeout=300, cwd=REPO_ROOT,
            env=cli_env(cfg))
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stdout

    heatmaps = d["PATHS"]["HEATMAPS"]
    out = run("--limit", "4", "--mode", "plusplus", "--profile")
    assert len(glob.glob(os.path.join(heatmaps, "heatmap_*.png"))) == 4
    assert "profiler trace written to" in out
    trace, = glob.glob(os.path.join(d["PATHS"]["LOGS"], "profiles", "*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"gradcam.{stage}" for stage in
            ("preprocess", "forward", "gradient", "heatmap")} <= names
    import pandas as pd

    name = pd.read_csv(fcsv)["Frame Path"].iloc[5]
    for p in glob.glob(os.path.join(heatmaps, "*.png")):
        os.remove(p)
    run("--frames", os.path.join("some", "dir", name))
    pngs = glob.glob(os.path.join(heatmaps, "heatmap_*.png"))
    assert len(pngs) == 1 and os.path.splitext(name)[0] in pngs[0]
