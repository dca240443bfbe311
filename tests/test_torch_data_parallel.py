"""PyTorch port, the data-parallel training step (``train/loop.py``'s
``Trainer(mesh=)``, ``graph.set_data_parallel``): a cnn0 step whose batch
norms train, on 2 and 4 gloo ranks on the CPU (``tests/torch_ranks.py``),
each rank on its rows of one 16-frame batch (4 rows of mask 0 at the end:
the last rank of 4 holds only padding), against one process of the port
and against the JAX package's step on its 8-device mesh.

* With dropout 0.3 and the config's augmentation: N ranks draw what one
  process draws (the global batch's parts and masks, each rank keeping
  its rows), so the step is held to one process of the port by the
  train-step rule of ``tests/test_torch_train_step.py`` (an element whose
  float64 gradient, the one-process step in float64, is above 3e-5 within
  1e-2 of lr plus 1e-7; every element within twice the step), the
  running statistics and the loss within 1e-5 relative, and every count
  of the metrics exact.
* At dropout 0 without augmentation (the packages' random streams
  differ): against JAX's mesh step by the same rule, statistics within
  1e-5 relative.
* The batch's first half is darker than its second, so each rank's own
  batch statistics are far from the global batch's: with batch norms on
  each rank's rows alone (what ``F.batch_norm`` does per process) the
  running means miss one process's by more than 1e-2 relative, where the
  synchronized ones meet 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import (HPARAMS, batch, check_update, leaves,
                                   scaled_variables)
from torch_ranks import CW, run_ranks

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.ops import metrics as jax_M
from ab_line_classifier_tpu.parallel import mesh as jax_mesh
from ab_line_classifier_tpu.train.loop import Trainer as JaxTrainer
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

SHAPE = (32, 32, 3)
HP0 = HPARAMS["cnn0"]
HP = dict(HP0, DROPOUT=0.3)
AUG = {"ZOOM_RANGE": 0.1, "WIDTH_SHIFT_RANGE": 0.2,
       "HEIGHT_SHIFT_RANGE": 0.2, "ROTATION_RANGE": 45,
       "HORIZONTAL_FLIP": True, "BRIGHTNESS_RANGE": 0.3}
RTOL = 1e-5


def split_batch():
    images, labels, mask = batch()
    images[:8] = (images[:8] * 0.3).astype(np.uint8)
    return images, labels, mask


@pytest.fixture(scope="module")
def setup():
    jax_spec = jax_build_model("cnn0", HP0, SHAPE, 2)
    port_spec = build_model("cnn0", HP0, SHAPE, 2)
    v = scaled_variables(jax_spec, port_spec, batch(seed=5)[0])
    images, labels, mask = split_batch()
    return {"jax_spec": jax_spec, "variables": v,
            "inputs": {"hp": HP, "hp0": HP0, "aug": AUG,
                       "state": state_dict_from_flax(v), "images": images,
                       "labels": labels, "mask": mask}}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, setup, tmp_path_factory):
    world = request.param
    return world, run_ranks("data_parallel", world, setup["inputs"],
                            str(tmp_path_factory.mktemp(f"dp{world}")))


def one_process(inp, hp, aug, dtype=torch.float32):
    """The same step in one process of the port (``dtype`` float64: the
    rule's gradients)."""
    spec = build_model("cnn0", hp, SHAPE, 2)
    tr = Trainer(spec, class_weight=CW, aug_config=aug, seed=0,
                 compute_dtype=dtype, device="cpu")
    if dtype == torch.float64:
        for m in tr.module.modules():
            if isinstance(m, G.BatchNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.double()
                for n, b in list(m.named_buffers(recurse=False)):
                    setattr(m, n, b.double())
    tr.begin_phase(0, spec.phases[0], inp["state"])
    metrics = M.init_metrics(2)
    loss = tr.train_step(*(torch.as_tensor(inp[k])
                           for k in ("images", "labels", "mask")), metrics)
    grads = {k: p.grad.numpy() for k, p in tr.module.named_parameters()
             if p.grad is not None}
    return {"state": tr.state(), "metrics": vars(metrics),
            "loss": float(loss), "grads": grads, "lr": spec.phases[0].lr}


def as_flax(state):
    return flax_from_state_dict(state)


def stats_err(got, want):
    """Largest relative error of the running statistics."""
    err = 0.0
    for k, w in want.items():
        if "running" in k:
            err = max(err, float((got[k] - w).abs().max()
                                 / w.abs().max().clamp(min=1e-12)))
    return err


def test_step_with_dropout_and_augmentation_matches_one_process(ranks,
                                                                 setup):
    world, res = ranks
    got = res["random"]
    inp = setup["inputs"]
    want = one_process(inp, HP, AUG)
    g64 = one_process(inp, HP, AUG, torch.float64)["grads"]
    moved = check_update(setup["variables"], as_flax(got["state"]),
                         as_flax(want["state"]), g64, want["lr"], 1.0)
    assert moved > 0
    assert stats_err(got["state"], want["state"]) <= RTOL
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    for k, w in want["metrics"].items():
        if k == "loss_sum":
            np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL)
        else:  # counts: exact
            assert torch.equal(got["metrics"][k], w), (world, k)


def test_step_matches_jax_mesh_step(ranks, setup):
    """Dropout 0, no augmentation: the N-rank step against the JAX
    package's Trainer on its 8-device mesh (the batch sharded, XLA's
    psum)."""
    world, res = ranks
    got = res["plain"]
    inp = setup["inputs"]
    v = setup["variables"]
    mesh = jax_mesh.make_mesh(n_data=8, n_trial=1)
    jt = JaxTrainer(setup["jax_spec"], class_weight=CW, seed=0, mesh=mesh)
    phase = setup["jax_spec"].phases[0]
    jt._set_phase_module(phase)
    state, tx = jt.init_state(phase, v)
    step = jt.make_train_step(phase, tx, 0)
    state, metrics = step(state, jax_M.init_metrics(2),
                          *jax_mesh.shard_batch(mesh, inp["images"],
                                                inp["labels"], inp["mask"]))
    want = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    g64 = one_process(inp, HP0, None, torch.float64)["grads"]
    check_update(v, as_flax(got["state"]), want, g64, phase.lr, 1.0)
    gs = leaves({"batch_stats": as_flax(got["state"])["batch_stats"]})
    ws = leaves({"batch_stats": want["batch_stats"]})
    for key in ws:
        np.testing.assert_allclose(gs[key], ws[key], rtol=RTOL, atol=1e-7,
                                   err_msg=key)
    m = jax_M.compute_metrics(metrics)
    got_m = M.compute_metrics(M.MetricsState(**got["metrics"]))
    for k in ("loss", "accuracy", "auc"):
        np.testing.assert_allclose(got_m[k], float(m[k]), rtol=RTOL,
                                   atol=1e-7)


def test_per_rank_batch_statistics_would_fail(ranks, setup):
    world, res = ranks
    want = one_process(setup["inputs"], HP0, None)["state"]
    synced = stats_err(res["plain"]["state"], want)
    per_rank = stats_err(res["per_rank_bn"]["state"], want)
    assert synced <= RTOL
    assert per_rank > 1e-2, per_rank
