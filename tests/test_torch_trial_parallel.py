"""PyTorch port, trial-parallel training (``parallel/trial_parallel.py``
and the trial-parallel experiments) against the JAX package, on the CPU.

The model is cnn0 at 32x32 with batch norms that train, as the JAX
package's ``tests/test_trial_parallel.py`` builds it, two folds (ragged
index lists, padded by wraparound), uint8 frames from a numpy seed, and
each trial's weights carried from JAX to the port through the weight
bridge (``utils/jax_params.py``). Comparisons of steps run without
augmentation and at dropout 0 (the packages' random streams differ).

Tolerances: a stacked step against the JAX package's
``ParallelFoldTrainer`` step holds parameters by the train-step rule of
``tests/test_torch_train_step.py`` (an element whose float64 gradient,
the port's serial step in float64, is above 3e-5 within 1e-2 of lr plus
1e-7; every element within twice the step), Adam's first moments within
1e-4 of their tensor's largest and its second moments within 2e-4 of
theirs (float32 gradients of the two packages differ by ~1e-5 relative),
batch-norm statistics within 1e-5 relative, the step's metrics within
1e-5. A stacked step against F serial port steps: parameters and
statistics 1e-7 absolute plus 1e-5 relative, Adam's first moments within
1e-5 of their tensor's largest (the same arithmetic in other kernels:
vmap's grouped conv and batched matmul, the stacked batch norm written out
where the serial one calls ``F.batch_norm``). Freezes, resumes and the
stacked depthwise path: bit for bit.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import derive_workspace_config, randomize_leaves

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.parallel import trial_parallel as jax_tp
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import make_optimizer
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.parallel import trial_parallel as tp
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

SHAPE = (32, 32, 3)
HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 1e-4, "NODES_DENSE0": 8,
      "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
      "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}
HP0 = dict(HP, DROPOUT=0.0)
N_FRAMES = 48
BATCH = 16
CLASS_W = np.array([[0.7, 1.6], [1.2, 0.85]], np.float32)
AUG = {"ZOOM_RANGE": 0.1, "WIDTH_SHIFT_RANGE": 0.2,
       "HEIGHT_SHIFT_RANGE": 0.2, "ROTATION_RANGE": 45,
       "HORIZONTAL_FLIP": True, "BRIGHTNESS_RANGE": 0.3}
G_FLAT = 3e-5


def fold_data(seed=5):
    """Frames, labels and two folds' ragged train / val row lists."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (N_FRAMES,) + SHAPE).astype(np.uint8)
    labels = rng.randint(0, 2, N_FRAMES).astype(np.int32)
    train = [np.arange(0, 21), np.arange(14, 40)]
    val = [np.arange(40, 45), np.arange(21, 28)]
    return frames, labels, train, val


def trial_variables(jax_spec, seeds=(0, 1)):
    """Each trial's JAX variables: every leaf randomized, batch-norm
    variances positive, kernels at O(1) gain."""
    out = []
    for s in seeds:
        v = randomize_leaves(jax_spec.init_variables(jax.random.PRNGKey(0)),
                             s)

        def scale(path, a):
            a = np.asarray(a)
            if path[-1].key == "kernel":
                return ((a - 0.1) * 1.5 / np.sqrt(np.prod(a.shape[:-1]))
                        ).astype(np.float32)
            if path[-1].key == "scale":
                return (0.4 + 0.2 * (a - 0.1)).astype(np.float32)
            return a.astype(np.float32)
        out.append(jax.tree_util.tree_map_with_path(scale, v))
    return out


def first_batch(frames, labels, train):
    """The first ``[F, B]`` batch of the epoch-0 tables, both packages'."""
    rng = np.random.RandomState(0)
    shuffled = [rng.permutation(ix) for ix in train]
    table, mask = tp.pad_index_table(shuffled, pad_to=2 * BATCH)
    idx, msk = table[:, :BATCH], mask[:, :BATCH]
    return frames[idx], labels[idx], msk


def port_stacked(pt, states):
    """A port trainer's stacked ``(params, buffers)`` from per-trial state
    dicts."""
    names = {n for n, _ in pt.module.named_parameters()}
    stacked = {k: tp._stack([s[k] for s in states], "cpu")
               for k in states[0]}
    return ({k: v for k, v in stacked.items() if k in names},
            {k: v for k, v in stacked.items() if k not in names})


def leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def adam_state(opt):
    """The ``ScaleByAdamState`` inside an optax state."""
    found = []

    def walk(x):
        if isinstance(x, optax.ScaleByAdamState):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
        elif hasattr(x, "inner_states"):
            walk(x.inner_states)
        elif hasattr(x, "inner_state"):
            walk(x.inner_state)
    walk(opt)
    assert len(found) == 1
    return found[0]


def port_trial_tree(params, buffers, t):
    """Trial t of the port's stacked state as the JAX variables tree."""
    sd = {k: v[t].detach() for k, v in {**params, **buffers}.items()}
    return flax_from_state_dict(sd)


def grads64(spec, variables, images, labels, mask, class_w):
    """The port's gradients of one serial step in float64."""
    tr = Trainer(spec, class_weight={0: float(class_w[0]),
                                     1: float(class_w[1])},
                 compute_dtype=torch.float64, device="cpu")
    for m in tr.module.modules():
        if isinstance(m, G.BatchNorm):
            for p in m.parameters(recurse=False):
                p.data = p.data.double()
            for n, b in list(m.named_buffers(recurse=False)):
                setattr(m, n, b.double())
    tr.begin_phase(0, spec.phases[0], state_dict_from_flax(variables))
    tr.train_step(torch.from_numpy(images), torch.from_numpy(labels),
                  torch.from_numpy(mask), M.init_metrics(2))
    grads = {n: p.grad.to(torch.float32)
             for n, p in tr.module.named_parameters() if p.grad is not None}
    return leaves(flax_from_state_dict(grads)["params"])


@pytest.mark.parametrize("lists,pad_to", [
    ([[1, 2, 3], [4]], None),
    ([[7, 8], [1, 2, 3, 4, 5]], None),
    ([[5], [9, 10, 11], [0, 1]], 7),
    ([[3, 1, 4, 1, 5], [9, 2]], 12),
])
def test_pad_index_table_matches_jax(lists, pad_to):
    ix = [np.asarray(a) for a in lists]
    got = tp.pad_index_table(ix, pad_to=pad_to)
    want = jax_tp.pad_index_table(ix, pad_to=pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pad_index_table_empty_trial_raises():
    with pytest.raises(ValueError, match="empty index list"):
        tp.pad_index_table([np.arange(3), np.array([], np.int64)])
    with pytest.raises(ValueError, match="empty index list"):
        jax_tp.pad_index_table([np.arange(3), np.array([], np.int64)])


def test_stacked_step_matches_jax():
    """One stacked cnn0 step from the same two trials' weights, class
    weights and index tables as the JAX package's vmapped step."""
    frames, labels, train, _ = fold_data()
    jax_spec = jax_build_model("cnn0", HP0, SHAPE, 2)
    spec = build_model("cnn0", HP0, SHAPE, 2)
    variables = trial_variables(jax_spec)
    images, lbs, msk = first_batch(frames, labels, train)

    jpt = jax_tp.ParallelFoldTrainer(jax_spec, 2, class_weights=CLASS_W,
                                     seed=0)
    _, _, opt0, tx = jpt.init_stacked(jax_spec.phases[0])
    stack = lambda *a: jnp.stack([jnp.asarray(x) for x in a])  # noqa: E731
    p0 = jax.tree.map(stack, *[v["params"] for v in variables])
    bs0 = jax.tree.map(stack, *[v["batch_stats"] for v in variables])
    step = jpt.make_train_step(tx)
    jp, jbs, jopt, jst = step(p0, bs0, opt0, jnp.asarray(images),
                              jnp.asarray(lbs), jnp.asarray(msk),
                              jnp.ones(2), jnp.ones(2),
                              jax.random.fold_in(jpt.base_rng, 0))

    pt = tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W, device="cpu")
    params, buffers = port_stacked(pt, [state_dict_from_flax(v)
                                        for v in variables])
    opt = pt.begin_phase(0, spec.phases[0], params)
    metrics = M.init_metrics(2, trials=2)
    pt.train_step(params, buffers, opt, torch.from_numpy(images),
                  torch.from_numpy(lbs).long(), torch.from_numpy(msk),
                  np.ones(2), np.ones(2), metrics)

    lr = spec.phases[0].lr
    adam = adam_state(jopt)
    for t in range(2):
        got = leaves(port_trial_tree(params, buffers, t))
        want = leaves({"params": jax.tree.map(lambda a: a[t], jp),
                       "batch_stats": jax.tree.map(lambda a: a[t], jbs)})
        old = leaves(variables[t])
        g64 = grads64(spec, variables[t], images[t], lbs[t], msk[t],
                      CLASS_W[t])
        for key, w in want.items():
            if key.startswith("batch_stats"):
                np.testing.assert_allclose(got[key], w, rtol=1e-5,
                                           atol=1e-7, err_msg=key)
                assert not np.array_equal(w, old[key]), key
                continue
            g = g64[key.split("/", 1)[1]]
            tight = np.abs(g) > G_FLAT
            assert tight.any(), key
            np.testing.assert_allclose(got[key][tight], w[tight], rtol=0,
                                       atol=1e-2 * lr + 1e-7, err_msg=key)
            np.testing.assert_allclose(got[key], w, rtol=0, atol=2 * lr,
                                       err_msg=key)
        sd = {k: opt.state[k]["m"][t] for k in opt.state}
        m_got = leaves({"params": flax_from_state_dict(sd)["params"]})
        sd = {k: opt.state[k]["v"][t] for k in opt.state}
        v_got = leaves({"params": flax_from_state_dict(sd)["params"]})
        m_want = leaves({"params": jax.tree.map(lambda a: a[t], adam.mu)})
        v_want = leaves({"params": jax.tree.map(lambda a: a[t], adam.nu)})
        for key in m_want:
            scale = np.abs(m_want[key]).max()
            np.testing.assert_allclose(m_got[key], m_want[key], rtol=0,
                                       atol=1e-4 * scale, err_msg=key)
            scale = np.abs(v_want[key]).max()
            np.testing.assert_allclose(v_got[key], v_want[key], rtol=0,
                                       atol=2e-4 * scale, err_msg=key)
        assert int(adam.count[t]) == int(opt.count[t]) == 1
    from ab_line_classifier_tpu.ops import metrics as jax_M
    want_m = jax.vmap(jax_M.compute_metrics)(jst)
    got_m = M.compute_stacked_metrics(metrics)
    for t in range(2):
        for key in ("loss", "accuracy", "auc"):
            np.testing.assert_allclose(got_m[t][key],
                                       float(want_m[key][t]), rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
def test_stacked_step_equals_serial_steps(name):
    """A stacked step of two trials (their own weights, class weights,
    batches and masks) against each trial's serial ``Trainer`` step: the
    parameters, batch-norm statistics, Adam moments and metrics.
    mobilenetv2 (cut at ``block_5_add``, every layer but the batch norms
    trainable) runs its depthwise layers through kernel B2's stacked
    path."""
    from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS

    hp = (HP0 if name == "cnn0" else
          dict(ZOO_HPARAMS["mobilenetv2"], DROPOUT=0.0, CUTOFF_IDX=53,
               FREEZE_IDX=-1))
    spec = build_model(name, hp, SHAPE, 2)
    frames, labels, train, _ = fold_data()
    images, lbs, msk = first_batch(frames, labels, train)
    states, serial = [], []
    for t in range(2):
        tr = Trainer(spec, class_weight=dict(enumerate(CLASS_W[t].tolist())),
                     seed=t, device="cpu")
        states.append({k: v.clone()
                       for k, v in tr.module.state_dict().items()})
        tr.begin_phase(0, spec.phases[0])
        m = M.init_metrics(2)
        tr.train_step(torch.from_numpy(images[t]),
                      torch.from_numpy(lbs[t]).long(),
                      torch.from_numpy(msk[t]), m)
        moments = {n: tr.optimizer.state[p]["m"]
                   for n, p in tr.module.named_parameters()
                   if p in tr.optimizer.state}
        serial.append((tr.state(), M.compute_metrics(m), moments))

    pt = tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W, device="cpu")
    params, buffers = port_stacked(pt, states)
    opt = pt.begin_phase(0, spec.phases[0], params)
    metrics = M.init_metrics(2, trials=2)
    pt.train_step(params, buffers, opt, torch.from_numpy(images),
                  torch.from_numpy(lbs).long(), torch.from_numpy(msk),
                  np.ones(2), np.ones(2), metrics)
    got_m = M.compute_stacked_metrics(metrics)
    for t, (sd, met, moments) in enumerate(serial):
        for k, want in sd.items():
            got = (params[k] if k in params else buffers[k])[t].detach()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7,
                                       msg=k)
            if k.endswith("running_var") and name == "cnn0":
                assert not torch.equal(want, states[t][k])
        for k, want in moments.items():
            torch.testing.assert_close(
                opt.state[k]["m"][t], want, rtol=0,
                atol=1e-5 * float(want.abs().max()), msg=k)
        for k, v in met.items():
            np.testing.assert_allclose(got_m[t][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def _stacked_cnn0(seed=0):
    spec = build_model("cnn0", HP0, SHAPE, 2)
    pt = tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W, seed=seed,
                                device="cpu")
    params, buffers = pt.init_stacked()
    return spec, pt, params, buffers


def _snapshot(params, buffers, opt):
    return ({k: v.detach().clone() for k, v in {**params,
                                                **buffers}.items()},
            {k: {s: t.clone() for s, t in slots.items()}
             for k, slots in opt.state.items()}, opt.count.copy())


def test_frozen_trial_stays_bit_unchanged():
    """``lr_factor`` 0 leaves the trial's parameters bit-unchanged while
    the other trial moves (its moments and batch-norm statistics move, as
    in the JAX package, where only ``active`` gates them); ``active`` 0
    leaves its parameters, moments, step count and statistics
    bit-unchanged. Two steps each, from a state whose moments are not
    zero."""
    frames, labels, train, _ = fold_data()
    images, lbs, msk = first_batch(frames, labels, train)
    batch = (torch.from_numpy(images), torch.from_numpy(lbs).long(),
             torch.from_numpy(msk))
    spec, pt, params, buffers = _stacked_cnn0()
    opt = pt.begin_phase(0, spec.phases[0], params)
    metrics = M.init_metrics(2, trials=2)
    pt.train_step(params, buffers, opt, *batch, np.ones(2), np.ones(2),
                  metrics)
    for factor, active in (([0.0, 1.0], [1.0, 1.0]),
                           ([1.0, 1.0], [1.0, 0.0])):
        frozen = 0 if factor[0] == 0 else 1
        before, moments, count = _snapshot(params, buffers, opt)
        for _ in range(2):
            pt.train_step(params, buffers, opt, *batch, np.array(factor),
                          np.array(active), metrics)
        after, moments2, count2 = _snapshot(params, buffers, opt)
        for k in params:
            assert torch.equal(after[k][frozen], before[k][frozen]), k
            assert not torch.equal(after[k][1 - frozen],
                                   before[k][1 - frozen]), k
        stats = [k for k in buffers if "running" in k]
        assert stats
        gated = active[frozen] == 0
        for k in stats:
            assert torch.equal(after[k][frozen], before[k][frozen]) == gated
        for k, slots in moments.items():
            for s in slots:
                assert torch.equal(moments2[k][s][frozen],
                                   slots[s][frozen]) == gated, (k, s)
        assert (count2[frozen] == count[frozen]) == gated
        assert count2[1 - frozen] == count[1 - frozen] + 2


def test_lr_factor_zero_freezes_fold_in_fit():
    """The counterpart of the JAX package's
    ``test_lr_factor_zero_freezes_fold``: a fit at factors ``[1, 0]``
    leaves fold 1's parameters where they started."""
    frames, labels, train, val = fold_data()
    spec, pt, params, _ = _stacked_cnn0()
    best, hist = pt.fit(frames, labels, train, val, batch_size=BATCH,
                        epochs=1, patience=4, verbose=False,
                        lr_factors=np.array([1.0, 0.0]))
    for k, v in params.items():
        assert torch.equal(best["params"][k][1], v[1]), k
    assert not torch.equal(best["params"]["conv2d_block0_0.weight"][0],
                           params["conv2d_block0_0.weight"][0])
    assert hist[0]["val_loss"].shape == (2,)


def test_lr_factors_dict_keyed_by_hparam_names_raises():
    """A factor dict keyed by hyperparameter names raises as the JAX
    package's fit does."""
    frames, labels, train, val = fold_data()
    spec, pt, _, _ = _stacked_cnn0()
    with pytest.raises(ValueError, match="keys must be phase names"):
        pt.fit(frames, labels, train, val, batch_size=BATCH, epochs=1,
               lr_factors={"LR": np.ones(2)}, verbose=False)
    jax_spec = jax_build_model("cnn0", HP, SHAPE, 2)
    jpt = jax_tp.ParallelFoldTrainer(jax_spec, 2, class_weights=CLASS_W,
                                     seed=0)
    with pytest.raises(ValueError, match="keys must be phase names"):
        jpt.fit(frames, labels, train, val, batch_size=BATCH, epochs=1,
                lr_factors={"LR": np.ones(2)}, verbose=False)


def test_stacked_batch_norm_statistics_follow_flax():
    """After a stacked step, each trial's running statistics are flax's
    rule on its own batch: ``m * ra + (1 - m) * stat``, the batch mean and
    the biased variance of the layer's input, computed here in float64
    from that trial's float64 forward to the layer."""
    frames, labels, train, _ = fold_data()
    images, lbs, msk = first_batch(frames, labels, train)
    spec, pt, params, buffers = _stacked_cnn0()
    old = {k: v.detach().clone() for k, v in {**params, **buffers}.items()}
    opt = pt.begin_phase(0, spec.phases[0], params)
    pt.train_step(params, buffers, opt, torch.from_numpy(images),
                  torch.from_numpy(lbs).long(), torch.from_numpy(msk),
                  np.ones(2), np.ones(2), M.init_metrics(2, trials=2))
    m = pt.module.bn_block0.momentum
    conv = G.GraphModule(spec.graph.cut("conv2d_block0_0")).double()
    for t in range(2):
        conv.load_state_dict({k: old[k][t].double()
                              for k in ("conv2d_block0_0.weight",
                                        "conv2d_block0_0.bias")})
        x = pt.preprocess_fn(torch.from_numpy(images[t]).double())
        with torch.no_grad():
            a = conv(x).reshape(-1, 4)
        mean, var = a.mean(0), a.var(0, unbiased=False)
        for stat, want in (("running_mean", mean), ("running_var", var)):
            key = f"bn_block0.{stat}"
            expect = m * old[key][t].double() + (1 - m) * want
            torch.testing.assert_close(buffers[key][t].double(), expect,
                                       rtol=1e-5, atol=1e-6, msg=key)


def test_resumed_fit_is_bit_equal(tmp_path):
    """A fit interrupted after an epoch and resumed lands bit for bit where
    the uninterrupted one does (augmentation and dropout on: the step
    generators follow the restored step index), with the whole history."""
    frames, labels, train, val = fold_data()
    spec = build_model("cnn0", HP, SHAPE, 2)

    def make():
        return tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W, seed=3,
                                      aug_config=AUG, device="cpu")

    full, hist_full = make().fit(frames, labels, train, val,
                                 batch_size=BATCH, epochs=3, patience=2,
                                 verbose=False)
    ck = str(tmp_path / "ck")
    make().fit(frames, labels, train, val, batch_size=BATCH, epochs=1,
               patience=2, verbose=False, checkpoint_dir=ck)
    res, hist_res = make().fit(frames, labels, train, val, batch_size=BATCH,
                               epochs=3, patience=2, verbose=False,
                               checkpoint_dir=ck, resume=True)
    assert [h["epoch"] for h in hist_res] == [h["epoch"] for h in hist_full]
    assert len(hist_full) >= 2
    for a, b in zip(hist_full, hist_res):
        for key in ("val_loss", "train_loss", "active"):
            np.testing.assert_array_equal(a[key], b[key])
    for part in ("params", "buffers"):
        for k, v in full[part].items():
            assert torch.equal(v, res[part][k]), k


# -- the LR search's candidates, factors and selection ---------------------
@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from ab_line_classifier_tpu.data.synthetic import generate_dataset

    ws = str(tmp_path_factory.mktemp("torch_trial_parallel"))
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=10,
                                        clips_per_patient=1,
                                        frames_per_clip=3, hw=(32, 32),
                                        seed=7)
    return derive_workspace_config(ws, fcsv, ccsv, fdir)


class _FakeTrainer:
    """Stands in for either package's ``ParallelFoldTrainer`` in
    ``lr_search_parallel``: records the factors and returns a fixed
    history (2 epochs of val_loss / val_auc per trial)."""

    calls = []

    def __init__(self, spec, n, **kw):
        self.n = n
        _FakeTrainer.calls.append({"n": n, **kw})

    def fit(self, *a, lr_factors=None, **kw):
        _FakeTrainer.calls[-1]["lr_factors"] = lr_factors
        rng = np.random.RandomState(self.n)
        history = [{"epoch": e, "phase": "p",
                    "val_loss": rng.uniform(0.3, 0.9, self.n),
                    "val_auc": rng.uniform(0.4, 0.9, self.n),
                    "train_loss": rng.uniform(0.3, 0.9, self.n)}
                   for e in range(2)]
        return {"params": {"w": np.zeros((self.n, 1))}}, history


def _search_cfg(d, model, space, metric, goal, n):
    import copy

    d = copy.deepcopy(d)
    d["TRAIN"].update({"MODEL_DEF": model, "EPOCHS": 2, "BATCH_SIZE": 8,
                       "MIXED_PRECISION": False})
    d["TRAIN"]["HPARAM_SEARCH"].update(
        {"N_EVALS": n, "METRIC_NAME": metric, "METRIC_GOAL": goal})
    d["HPARAM_SEARCH"][model.upper()] = space
    return d


SEARCHES = [
    ("cnn0", {"LR": {"TYPE": "float_log", "RANGE": [1e-4, 1e-2]}},
     "epoch/val_loss", "minimize", 4),
    ("cnn0", {"LR": {"TYPE": "float_uniform", "RANGE": [1e-4, 1e-2]},
              "DROPOUT": {"TYPE": "float_uniform", "RANGE": [0.1, 0.5]}},
     "epoch/val_auc", "maximize", 3),
    ("cutoffvgg16", {"LR_EXTRACT": {"TYPE": "float_log",
                                    "RANGE": [1e-5, 1e-3]},
                     "LR_FINETUNE": {"TYPE": "float_log",
                                     "RANGE": [1e-6, 1e-4]}},
     "epoch/val_loss", "minimize", 3),
    ("cutoffvgg16", {"LR_FINETUNE": {"TYPE": "float_log",
                                     "RANGE": [1e-6, 1e-4]}},
     "test/f1", "minimize", 2),
]


@pytest.mark.parametrize("model,space,metric,goal,n", SEARCHES)
def test_lr_search_candidates_factors_and_selection_match_jax(
        workspace, monkeypatch, capsys, tmp_path, model, space, metric, goal,
        n):
    """Both packages' ``lr_search_parallel`` with their trainer replaced by
    one fixed history: the same candidates (a log or linear grid for
    ``LR``; seeded draws for cutoffvgg16's phase rates), the same
    per-phase factor dict, the same per-trial objectives and winner (the
    metric at each trial's best-val-loss epoch; a metric the history lacks
    falls back to val_auc, maximized), the same messages and CSV
    columns."""
    from ab_line_classifier_tpu.config import Config as JaxConfig
    from ab_line_classifier_tpu.train import experiment as JE
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.train import experiment as E

    d = _search_cfg(workspace, model, space, metric, goal, n)
    results = {}
    for label, cfg, module, exp in (
            ("jax", JaxConfig(d), jax_tp, JE),
            ("port", Config(d), tp, E)):
        _FakeTrainer.calls = []
        monkeypatch.setattr(module, "ParallelFoldTrainer", _FakeTrainer)
        if label == "port":
            monkeypatch.setattr(tp, "trial_state",
                                lambda best, t: {"t": t})
        cfg = cfg.replace(PATHS={"EXPERIMENTS": str(tmp_path / label)})
        kw = {} if label == "jax" else {"device": "cpu"}
        out = exp.lr_search_parallel(cfg, verbose=False, **kw)
        printed = capsys.readouterr().out
        csv = glob.glob(str(tmp_path / label / "lr_sweep_parallel_*.csv"))
        assert len(csv) == 1
        results[label] = (out, _FakeTrainer.calls[-1], printed,
                          open(csv[0]).read().splitlines()[0])
    (jout, jcall, jtext, jhead), (pout, pcall, ptext, phead) = (
        results["jax"], results["port"])
    assert pout["trials"] == jout["trials"]
    assert pout["best_params"] == jout["best_params"]
    assert pout["best_objective"] == jout["best_objective"]
    assert phead == jhead
    assert ptext == jtext
    jf, pf = jcall["lr_factors"], pcall["lr_factors"]
    if isinstance(jf, dict):
        assert sorted(pf) == sorted(jf) == ["extract", "finetune"]
        for k in jf:
            np.testing.assert_array_equal(pf[k], jf[k])
    else:
        np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pcall["class_weights"],
                                  jcall["class_weights"])
    np.testing.assert_array_equal(pcall["output_biases"],
                                  jcall["output_biases"])
    if metric == "test/f1":
        assert "selecting by val_auc (maximize) instead" in ptext


@pytest.mark.parametrize("space,match", [
    ({"LR": {"TYPE": "float_log", "RANGE": [1e-4, 1e-2]},
      "LR_EXTRACT": {"TYPE": "float_log", "RANGE": [1e-5, 1e-3]}},
     "ambiguous"),
    ({"DROPOUT": {"TYPE": "float_uniform", "RANGE": [0.1, 0.5]}},
     "needs LR"),
])
def test_lr_search_errors_match_jax(workspace, capsys, space, match):
    """Both packages refuse an LR space that is ambiguous or absent, with
    the same message and the same notice of the ignored variables."""
    from ab_line_classifier_tpu.config import Config as JaxConfig
    from ab_line_classifier_tpu.train import experiment as JE
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.train import experiment as E

    d = _search_cfg(workspace, "cutoffvgg16", space, "epoch/val_loss",
                    "minimize", 2)
    with pytest.raises(ValueError, match=match) as jerr:
        JE.lr_search_parallel(JaxConfig(d), verbose=False)
    jtext = capsys.readouterr().out
    with pytest.raises(ValueError, match=match) as perr:
        E.lr_search_parallel(Config(d), verbose=False, device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert capsys.readouterr().out == jtext


@pytest.mark.parametrize("kind", ["adam", "rmsprop", "sgd"])
def test_stacked_optimizer_equals_one_trial_optimizers(kind):
    """``StackedOptimizer`` against the one-trial optimizer
    (``make_optimizer``: Keras Adam, RMSprop, SGD) per trial over three
    steps of random gradients: a trial at factor 1 bit-equal; a trial at
    factor 0.5 as the one-trial optimizer at half the rate (within float32
    rounding); a trial made inactive at the third step keeps its
    parameters, moments and step count (its one-trial optimizer skips that
    step)."""
    from ab_line_classifier_torch.models.common import (StackedOptimizer,
                                                        TrainPhase)

    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn((3, 5, 4), generator=gen)
    grads = [torch.randn((3, 5, 4), generator=gen) for _ in range(3)]
    factors = np.array([1.0, 0.5, 1.0], np.float32)
    actives = [np.ones(3), np.ones(3), np.array([1.0, 1.0, 0.0])]
    phase = TrainPhase(name="p", optimizer=kind, lr=1e-2,
                       trainable={"layer": True})
    params = {"layer.weight": w0.clone()}
    opt = StackedOptimizer(phase, params)
    for g, act in zip(grads, actives):
        params["layer.weight"].grad = g.clone()
        opt.step(params, factors, act)
    for t in range(3):
        layer = torch.nn.Linear(4, 5, bias=False)
        with torch.no_grad():
            layer.weight.copy_(w0[t])
        one = make_optimizer(TrainPhase(name="p", optimizer=kind,
                                        lr=1e-2 * float(factors[t]),
                                        trainable={}), layer)
        for g, act in zip(grads, actives):
            if act[t] == 0:
                continue
            layer.weight.grad = g[t].clone()
            one.step()
        got = params["layer.weight"][t]
        if t == 1:
            torch.testing.assert_close(got, layer.weight.detach(),
                                       rtol=1e-6, atol=1e-8)
        else:
            assert torch.equal(got, layer.weight.detach()), t
        state = one.state[layer.weight]
        slots = {"adam": {"m": "m", "v": "v"},
                 "rmsprop": {"sq": "square_avg"}, "sgd": {}}[kind]
        for mine, theirs in slots.items():
            assert torch.equal(opt.state["layer.weight"][mine][t],
                               state[theirs]), (t, mine)
    assert opt.count.tolist() == [3, 3, 2]


def test_frame_table_gathers_trial_batches():
    """The frame table held once (``DeviceCachedDataset``) gathers an
    ``[F, B]`` index table into ``[F, B, H, W, 3]`` frames and ``[F, B]``
    labels in one gather each."""
    from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset

    frames, labels, train, _ = fold_data()
    cache = DeviceCachedDataset.from_arrays(frames, labels, "cpu")
    table, _ = tp.pad_index_table(train)
    images, lbs = cache.gather(table[:, :BATCH])
    assert images.shape == (2, BATCH) + SHAPE and images.dtype == torch.uint8
    np.testing.assert_array_equal(images.numpy(), frames[table[:, :BATCH]])
    np.testing.assert_array_equal(lbs.numpy(), labels[table[:, :BATCH]])


def test_frame_table_over_the_cache_budget_raises(workspace, tmp_path):
    """The union of the trials' rows must fit the device cache budget
    (``configured_cache_budget``): a table that does not raises with its
    size and the budget, before anything trains."""
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.train import experiment as E

    d = _search_cfg(workspace, "cnn0",
                    {"LR": {"TYPE": "float_log", "RANGE": [1e-4, 1e-2]}},
                    "epoch/val_loss", "minimize", 2)
    cfg = Config(d).replace(TRAIN={"USE_MEMORY_LIMIT": True,
                                   "MEMORY_LIMIT": 0, "N_FOLDS": 2},
                            DATA={"K_FOLD_VALIDATION_SPLIT": 0.3},
                            PATHS={"EXPERIMENTS": str(tmp_path)})
    for fn in (E.cross_validation_parallel, E.lr_search_parallel):
        with pytest.raises(MemoryError, match=r"frames of 32x32x3 uint8, "
                                              r"\d+ bytes\) does not fit"):
            fn(cfg, verbose=False, device="cpu")


def test_cross_validation_parallel_matches_jax(workspace, monkeypatch,
                                               tmp_path):
    """Both packages' ``cross_validation_parallel`` on the workspace's
    3 folds, with the trainer replaced by one that records what it is
    given and returns the same per-fold weights (JAX's, carried across):
    the same frames in every fold's train and val lists, class weights and
    output biases; the per-fold test metrics (each package's
    ``Predictor`` on the fold's test rows, float32) within 1e-5 and the
    ``kfold_parallel_*.csv`` columns and rows the same."""
    import csv

    from ab_line_classifier_tpu.config import Config as JaxConfig
    from ab_line_classifier_tpu.train import experiment as JE
    from ab_line_classifier_torch.config import Config
    from ab_line_classifier_torch.train import experiment as E

    d = _search_cfg(workspace, "cnn0", {}, "epoch/val_loss", "minimize", 1)
    d["HPARAMS"]["CNN0"].update(HP0)
    d["TRAIN"]["N_FOLDS"] = 3
    d["DATA"]["K_FOLD_VALIDATION_SPLIT"] = 0.3
    jax_spec = jax_build_model("cnn0", HP0, SHAPE, 2)
    variables = trial_variables(jax_spec, seeds=(0, 1, 2))
    seen = {}

    class Recorder:
        def __init__(self, spec, n, **kw):
            self.n, self.kw = n, kw

        def fit(self, frames, labels, train_idx, val_idx, **kw):
            port = not isinstance(frames, np.ndarray)
            table = frames.frames.numpy() if port else frames
            seen["port" if port else "jax"] = (
                [table[ix] for ix in train_idx], [table[ix] for ix in val_idx],
                self.kw["class_weights"], self.kw["output_biases"])
            if not port:
                return jax.tree.map(lambda *a: jnp.stack(a), *variables), []
            states = [state_dict_from_flax(v) for v in variables]
            return {"params": {k: torch.stack([s[k] for s in states])
                               for k in states[0] if "running" not in k},
                    "buffers": {k: torch.stack([s[k] for s in states])
                                for k in states[0] if "running" in k}}, []

    rows = {}
    for label, cfg, module, exp in (("jax", JaxConfig(d), jax_tp, JE),
                                    ("port", Config(d), tp, E)):
        monkeypatch.setattr(module, "ParallelFoldTrainer", Recorder)
        cfg = cfg.replace(PATHS={"EXPERIMENTS": str(tmp_path / label)})
        kw = {} if label == "jax" else {"device": "cpu"}
        exp.cross_validation_parallel(cfg, verbose=False, **kw)
        path, = glob.glob(str(tmp_path / label / "kfold_parallel_*.csv"))
        with open(path) as f:
            rows[label] = list(csv.reader(f))
    (jtr, jva, jcw, jb), (ptr, pva, pcw, pb) = seen["jax"], seen["port"]
    for a, b in zip(jtr + jva, ptr + pva):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jcw, pcw)
    np.testing.assert_array_equal(jb, pb)
    assert rows["port"][0] == rows["jax"][0]
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]] == [
        "fold", "0", "1", "2", "mean", "std"]
    for pr, jr in zip(rows["port"][1:], rows["jax"][1:]):
        np.testing.assert_allclose(
            np.array(pr[1:], float), np.array(jr[1:], float), rtol=1e-5,
            atol=1e-6)
