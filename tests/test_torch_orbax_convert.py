"""``scripts/orbax_to_torch.py``: JAX package checkpoints (Orbax ``state/``
and ``meta.json``) converted into port checkpoints (``state.pt`` and the
same ``meta.json``), for full-width cutoffvgg16 and mobilenetv2 in float32
and for a U-Net, whose ``meta.json`` names no zoo model.

The restored port models are held against the JAX models that were saved:
zoo probabilities within 1e-4 and logits within 1e-4 of their range (the
zoo's float32 bar, ``tests/test_torch_zoo.py``), U-Net masks within 1e-5.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, cli_env
from test_torch_model import serving_variables as vgg_variables
from test_torch_zoo import serving_variables as zoo_variables

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.models.unet import UNet as JaxUNet
from ab_line_classifier_tpu.ops.image import fused_preprocess
from ab_line_classifier_tpu.utils import checkpoint as jax_ckpt
from ab_line_classifier_torch.data.auto_masking import UnetSegmentation
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.unet import seeded_unet_state
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import flax_from_state_dict

SHAPE = (32, 32, 3)
ATOL = 1e-4
MASK_ATOL = 1e-5
SCRIPT = os.path.join(REPO_ROOT, "scripts", "orbax_to_torch.py")


def load_converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def zoo_checkpoint(name, root):
    """A float32 JAX checkpoint of ``name`` with weights whose logits are
    O(1), saved by the JAX package; returns (dir, variables, meta)."""
    hparams = ({"DROPOUT": 0.45, "CUTOFF_LAYER": 10, "FINETUNE_LAYER": 7}
               if name == "cutoffvgg16" else ZOO_HPARAMS[name])
    spec = jax_build_model(name, hparams, SHAPE, 2)
    if name == "cutoffvgg16":
        variables = vgg_variables(spec)
    else:
        inputs = np.array(fused_preprocess(
            jnp.asarray(frames()), out_hw=SHAPE[:2],
            preprocess_mode=spec.preprocess_mode))
        variables = zoo_variables(name, inputs)
    meta = {"model_name": name, "hparams": hparams,
            "input_shape": list(SHAPE), "n_classes": 2,
            "classes": ["a_lines", "b_lines"],
            "preprocess_mode": spec.preprocess_mode,
            "mixed_precision": False}
    d = jax_ckpt.save_model(os.path.join(root, f"jax_{name}"), variables,
                            meta)
    return d, spec, meta


def frames():
    return np.random.RandomState(3).randint(0, 256, (8,) + SHAPE).astype(
        np.uint8)


@pytest.mark.parametrize("name", ["cutoffvgg16", "mobilenetv2"])
def test_zoo_checkpoint_converts(tmp_path, name):
    src, jax_spec, meta = zoo_checkpoint(name, str(tmp_path))
    dst = load_converter().convert(src, str(tmp_path / f"port_{name}"))
    with open(os.path.join(dst, "meta.json")) as f:
        assert json.load(f) == meta
    variables, _ = jax_ckpt.load_model(src)
    x = np.array(fused_preprocess(jnp.asarray(frames()), out_hw=SHAPE[:2],
                                  preprocess_mode=jax_spec.preprocess_mode))
    want, caps = jax_spec.module(capture=("logits",)).apply(
        variables, jnp.asarray(x))

    state, port_meta = torch_ckpt.load_model(dst)
    assert port_meta == meta
    spec = build_model(name, meta["hparams"], SHAPE, 2)
    module = spec.module(capture=("logits",))
    module.load_state_dict(state)
    with torch.no_grad():
        got, got_caps = module.eval()(torch.from_numpy(x))
    logits = np.asarray(caps["logits"])
    assert np.ptp(logits[:, 1] - logits[:, 0]) > 0.05, "logits are flat"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_caps["logits"].numpy(), logits,
                               atol=ATOL * np.abs(logits).max())


def test_unet_checkpoint_converts_through_the_cli(tmp_path):
    """A U-Net's ``meta.json`` names no zoo model: the JAX package restores
    it without a target tree, and so does the converter, here run as the
    command a user types."""
    variables = flax_from_state_dict(seeded_unet_state(16, 7))
    meta = {"model_name": "unet", "base_filters": 16,
            "input_shape": [128, 128, 1]}
    src = jax_ckpt.save_model(str(tmp_path / "jax_unet"), variables, meta)
    dst = str(tmp_path / "port_unet")
    r = subprocess.run([sys.executable, SCRIPT, src, dst], env=cli_env(),
                       cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == os.path.abspath(dst)
    with open(os.path.join(dst, "meta.json")) as f:
        assert json.load(f) == meta

    x = np.random.default_rng(1).random((4, 128, 128, 1)).astype(np.float32)
    restored, _ = jax_ckpt.load_model(src)
    want = np.asarray(JaxUNet(base_filters=16).apply(
        jax.tree.map(np.asarray, dict(restored)), jnp.asarray(x)))
    seg = UnetSegmentation(dst, device="cpu")
    with torch.no_grad():
        got = seg.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_ATOL)
