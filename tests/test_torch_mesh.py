"""PyTorch port, the device mesh over process groups
(``parallel/mesh.py``): the counterparts of ``tests/test_mesh.py`` on 4
gloo ranks on the CPU (``tests/torch_ranks.py``), against the JAX package
on its 8-device virtual mesh and against one process of the port.

Cases: mesh shapes, the overcommit checks (and the port's one more: a
mesh must cover every rank), ``mesh_from_config``; each layout's rows;
the data-parallel gradients of JAX's toy loss (within 1e-5 of JAX's on
its mesh, as JAX holds its own); the metrics reduction (every count
exact, accuracy and AUC within 1e-5 of JAX's); ``host_local_batch``;
serving over every rank (the chunk rounded up to the world size),
bit-equal to one process; a fit under the mesh streamed from host arrays
(each rank reading only its rows) bit-equal to the same fit from the
device cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.ops import metrics as jax_M
from ab_line_classifier_tpu.parallel import mesh as jax_mesh
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.parallel import mesh as mesh_lib
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 0.0, "NODES_DENSE0": 8,
      "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
      "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}


def toy_loss(w, x, y):
    logp = jax.nn.log_softmax(x @ w)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    probs = np.random.RandomState(0).rand(16, 2).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels_oh = np.eye(2)[np.random.RandomState(1).randint(0, 2, 16)]
    spec = jax_build_model("cnn0", HP, (32, 32, 3), 2)
    variables = spec.init_variables(jax.random.PRNGKey(0))
    return {
        "w": np.random.RandomState(0).randn(4, 2).astype(np.float32),
        "x": np.random.RandomState(1).randn(16, 4).astype(np.float32),
        "y": np.random.RandomState(2).randint(0, 2, 16),
        "probs": probs, "labels_oh": labels_oh.astype(np.float32),
        "hp": HP, "state": state_dict_from_flax(variables),
        "frames": rng.randint(0, 256, (21, 32, 32, 3)).astype(np.uint8),
        "train": (rng.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8),
                  (np.arange(32) % 2).astype(np.int32)),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks("mesh", 4, inputs,
                     str(tmp_path_factory.mktemp("mesh")))


def test_make_mesh_shapes(ranks):
    assert ranks["shapes"] == ((2, 2), ("trial", "data"), (1, 4))


def test_mesh_overcommit_rejected(ranks):
    over, indivisible, under = ranks["errors"]
    assert "needs 8 devices, have 4" in over
    assert "not divisible by trial=3" in indivisible
    assert "leaves 2 of 4 processes out" in under
    # Without a process group there is no mesh to make.
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(n_data=2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(n_data=1)


def test_mesh_from_config(ranks):
    from ab_line_classifier_torch.config import Config

    assert ranks["config"] == ((2, 2), True, True)
    # World size 1: no mesh, as the JAX package has none on one device.
    one = Config({"PARALLEL": {"MESH": {"DATA": 1, "TRIAL": 2}}})
    assert mesh_lib.mesh_from_config(one) is None


def test_batch_layouts(ranks):
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    # Data axis: each rank its quarter; (2, 2): the trial ranks hold the
    # same half; serving: every rank its quarter, trial x data flattened.
    np.testing.assert_array_equal(ranks["data_rows"], x)
    np.testing.assert_array_equal(ranks["trial_data_rows"],
                                  np.concatenate([x[:8], x[8:]] * 2))
    np.testing.assert_array_equal(ranks["full_rows"], x)
    # Trials: 4 over 2 trial slices; 3 do not divide (replicated).
    np.testing.assert_array_equal(ranks["trials"],
                                  [0, 3, 0, 3, 2, 3, 2, 3])


def test_data_parallel_grad_matches_jax_mesh(ranks, inputs):
    """Each rank's local sum over the global count, summed over the data
    axis, against JAX's jitted gradient on its 8-device mesh (psum by
    XLA) and on one device."""
    w, x, y = (jnp.asarray(inputs[k]) for k in ("w", "x", "y"))
    g_single = jax.grad(toy_loss)(w, x, y)
    assert len(jax.devices()) >= 8
    mesh = jax_mesh.make_mesh(n_data=8, n_trial=1)
    xs = jax_mesh.shard_batch(mesh, inputs["x"])
    ys = jax_mesh.shard_batch(mesh, inputs["y"])
    wr = jax.device_put(w, jax_mesh.replicated(mesh))
    g_sharded = jax.jit(jax.grad(toy_loss))(wr, xs, ys)
    np.testing.assert_allclose(ranks["grad"], np.asarray(g_sharded),
                               atol=1e-5)
    np.testing.assert_allclose(ranks["grad"], np.asarray(g_single),
                               atol=1e-5)


def test_metrics_reduction(ranks, inputs):
    from ab_line_classifier_torch.ops import metrics as M

    one = M.init_metrics(2)
    M.update_metrics(one, torch.as_tensor(inputs["probs"]),
                     torch.as_tensor(inputs["labels_oh"]))
    for k, v in vars(one).items():
        # Every field is a count (n, correct, confusion counts) but the
        # loss sum, absent here.
        assert torch.equal(ranks["metrics_state"][k], v), k
    ref = jax_M.compute_metrics(jax_M.update_metrics(
        jax_M.init_metrics(2), jnp.asarray(inputs["probs"]),
        jnp.asarray(inputs["labels_oh"])))
    for k in ("accuracy", "auc"):
        np.testing.assert_allclose(ranks["metrics"][k], float(ref[k]),
                                   atol=1e-5)


def test_host_local_batch(ranks):
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    got_x, got_i = ranks["host_local"]
    # (2, 2): rank r loaded the quarter a (1, 4) mesh gives it.
    np.testing.assert_array_equal(got_x, x)
    np.testing.assert_array_equal(got_i, np.arange(16))
    assert "split evenly" in ranks["uneven"]
    # No process group: the arrays pass through.
    t = mesh_lib.host_local_batch(None, x)
    np.testing.assert_array_equal(t.numpy(), x)


def test_mesh_predictor_matches_one_process(ranks, inputs):
    """Serving over every rank (2 x 2) == one process of the port, bit for
    bit, the chunk rounded up from 6 to 8, a ragged tail included."""
    spec = build_model("cnn0", HP, (32, 32, 3), 2)
    single = Predictor(spec, inputs["state"], batch_size=6,
                       compute_dtype=torch.float32, device="cpu")
    want = single.predict_probs(inputs["frames"])
    assert ranks["batch_size"] == 8
    np.testing.assert_array_equal(ranks["probs"], want)
    np.testing.assert_array_equal(ranks["dataset_probs"], want)


def test_streaming_under_mesh_matches_device_cache(ranks):
    """A fit under a (1, 4) mesh from host arrays, each rank taking only
    its rows of every batch, equals the same fit from the device cache:
    histories and weights bit for bit."""
    (best_s, hist_s), (best_c, hist_c) = ranks["fits"]
    assert hist_s == hist_c
    for k in best_c:
        assert torch.equal(best_s[k], best_c[k]), k
