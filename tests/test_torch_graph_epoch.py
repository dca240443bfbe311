"""PyTorch port, graphed epochs (``train/graphed.py``; the JAX package's
one-program epochs, ``make_epoch_fns``) on the CPU, where the epoch's step
runs uncaptured: the code a CUDA graph of it replays on the card.

* The serial runner (``Trainer.run_epoch`` over a device cache) against
  the per-step epoch (``Trainer.run_epoch_per_step``) of the same trainer
  state, bit for bit (``torch.equal``) in parameters, batch-norm
  statistics, optimizer state and metrics: cnn0 (batch norms that train)
  under Keras Adam, RMSprop and SGD, and a cutoffvgg16 at 16x16 across
  its extract -> finetune boundary (frozen layers, a new optimizer), each
  with a learning-rate cut between two epochs of a phase, augmentation and
  dropout on; 24 frames at batch 16, so the last batch is padded.
* The stacked runner (``ParallelFoldTrainer.run_epoch``) against the
  per-step stacked epoch, bit for bit, over two epochs whose
  ``lr_factor`` and ``active`` change between them; without augmentation
  and dropout also against the JAX package's ``ParallelFoldTrainer``
  epoch (``make_epoch_fns``) by the tolerance of the stacked step's
  comparison (``tests/test_torch_trial_parallel.py``: metrics within
  1e-5, batch-norm statistics within 1e-5 relative, every parameter
  within twice a step of the rate for each step taken).
* Keras Adam's bias-correction table against the float32 host formula.
* A streamed epoch (``FrameArrays`` from host memory, through the pinned
  staging) against the cached epoch, bit for bit.
* The launch counts around a CUDA graph (``ops/launches.py``): a
  capture's wrapper calls come off the counts, each replay adds them;
  the cyclic collector is paused inside a capture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trial_parallel import (AUG, BATCH, CLASS_W, HP, HP0, SHAPE,
                                       fold_data, port_stacked,
                                       trial_variables)

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.ops import metrics as jax_M
from ab_line_classifier_tpu.parallel import trial_parallel as jax_tp
from ab_line_classifier_torch.data.pipeline import (DeviceCachedDataset,
                                                    FrameArrays)
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import (adam_alpha,
                                                    adam_alpha_table,
                                                    scale_learning_rate)
from ab_line_classifier_torch.parallel import trial_parallel as tp
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.utils.jax_params import state_dict_from_flax

N = 24
VGG_SHAPE = (16, 16, 3)
VGG_HP = dict(ZOO_HPARAMS["cutoffvgg16"], DROPOUT=0.3, EXTRACT_EPOCHS=2)


def frames(shape, seed=4):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (N,) + shape).astype(np.uint8)
    return images, rng.randint(0, 2, N).astype(np.int32)


def with_optimizer(spec, kind):
    return dataclasses.replace(spec, phases=tuple(
        dataclasses.replace(p, optimizer=kind) for p in spec.phases))


def drive(trainer, train_ds, val_ds, per_step, mode=None):
    """Every phase of the plan, two epochs each, the rate halved after the
    first: the metrics of each epoch, each run on the path ``mode``."""
    run = trainer.run_epoch_per_step if per_step else trainer.run_epoch
    mode = mode or ("per-step" if per_step else "uncaptured")
    logs = []
    for phase_idx, phase in enumerate(trainer.spec.phases):
        trainer.begin_phase(phase_idx, phase)
        for epoch in range(2):
            logs.append(run(train_ds, BATCH, train=True,
                            shuffle_seed=10 * phase_idx + epoch))
            logs.append(run(val_ds, BATCH, train=False))
            assert trainer.epoch_mode == mode
            if epoch == 0:
                scale_learning_rate(trainer.optimizer, 0.5)
    return logs


def assert_same_state(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert set(oa["state"]) == set(ob["state"])
    for i, slots in oa["state"].items():
        for k, v in slots.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step


@pytest.mark.parametrize("model,optimizer", [
    ("cnn0", "adam"), ("cnn0", "rmsprop"), ("cnn0", "sgd"),
    ("cutoffvgg16", None)])
def test_uncaptured_epoch_equals_per_step(model, optimizer):
    if model == "cnn0":
        spec = build_model("cnn0", HP, SHAPE, 2)
        images, labels = frames(SHAPE)
    else:
        spec = build_model("cutoffvgg16", VGG_HP, VGG_SHAPE, 2,
                           total_epochs=4)
        images, labels = frames(VGG_SHAPE)
    if optimizer is not None:
        spec = with_optimizer(spec, optimizer)
    tr_ds = DeviceCachedDataset.from_arrays(images, labels, "cpu")
    va_ds = DeviceCachedDataset.from_arrays(images[:20], 1 - labels[:20],
                                            "cpu")
    runs = []
    for per_step in (False, True):
        trainer = Trainer(spec, seed=3, aug_config=AUG,
                          class_weight={0: 0.8, 1: 1.3}, device="cpu")
        runs.append((trainer, drive(trainer, tr_ds, va_ds, per_step)))
    (graphed, got), (eager, want) = runs
    assert got == want
    assert_same_state(graphed, eager)
    if model == "cutoffvgg16":
        assert [p.optimizer for p in spec.phases] == ["adam", "rmsprop"]
        assert graphed.epoch_programs["train"].step.mode == "uncaptured"


def stacked_epochs(pt, params, buffers, cache, train, val, per_step):
    """Two epochs of one phase (``lr_factor`` and ``active`` changed
    between them): each epoch's train and val metrics, and the
    optimizer."""
    run = pt.run_epoch_per_step if per_step else pt.run_epoch
    opt = pt.begin_phase(0, pt.spec.phases[0], params)
    v_idx, v_mask = pt._batch_tables(val, BATCH)
    gates = [(np.array([1.0, 0.5], np.float32), np.ones(2, np.float32)),
             (np.array([0.5, 0.5], np.float32), np.array([1.0, 0.0],
                                                         np.float32))]
    logs = []
    for epoch, (factor, active) in enumerate(gates):
        rng = np.random.RandomState(epoch)
        idx, mask = pt._batch_tables([rng.permutation(ix) for ix in train],
                                     BATCH)
        logs.append(run(params, buffers, opt, cache, idx, mask, train=True,
                        lr_factor=factor, active=active))
        logs.append(run(params, buffers, None, cache, v_idx, v_mask,
                        train=False))
        assert pt.epoch_mode == ("per-step" if per_step else "uncaptured")
    return logs, opt


@pytest.mark.parametrize("draws", [False, True])
def test_stacked_runner_equals_per_step_and_jax(draws):
    """cnn0, two folds; with ``draws`` augmentation and dropout on."""
    images, labels, train, val = fold_data()
    hp = HP if draws else HP0
    spec = build_model("cnn0", hp, SHAPE, 2)
    jax_spec = jax_build_model("cnn0", hp, SHAPE, 2)
    variables = trial_variables(jax_spec)
    cache = DeviceCachedDataset.from_arrays(images, labels, "cpu")
    runs = []
    for per_step in (False, True):
        pt = tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W, seed=2,
                                    aug_config=AUG if draws else None,
                                    device="cpu")
        params, buffers = port_stacked(pt, [state_dict_from_flax(v)
                                            for v in variables])
        logs, opt = stacked_epochs(pt, params, buffers, cache, train, val,
                                   per_step)
        runs.append((params, buffers, opt, logs, pt.step))
    (p, b, opt, logs, step), (pw, bw, optw, logsw, stepw) = runs
    assert logs == logsw and step == stepw
    for k in {**p, **b}:
        assert torch.equal({**p, **b}[k], {**pw, **bw}[k]), k
    assert opt.count.tolist() == optw.count.tolist() == [4, 2]
    for name, slots in opt.state.items():
        for k, v in slots.items():
            assert torch.equal(v, optw.state[name][k]), (name, k)
    if draws:
        return

    # The JAX package's two scanned epochs from the same weights.
    jpt = jax_tp.ParallelFoldTrainer(jax_spec, 2, class_weights=CLASS_W,
                                     seed=0)
    _, _, jopt, tx = jpt.init_stacked(jax_spec.phases[0])
    stack = lambda *a: jnp.stack([jnp.asarray(x) for x in a])  # noqa: E731
    jp = jax.tree.map(stack, *[v["params"] for v in variables])
    jbs = jax.tree.map(stack, *[v["batch_stats"] for v in variables])
    train_epoch, eval_epoch = jpt.make_epoch_fns(tx)
    pt = tp.ParallelFoldTrainer(spec, 2, class_weights=CLASS_W,
                                device="cpu")
    v_idx, v_mask = (t.numpy() for t in pt._batch_tables(val, BATCH))
    jlogs = []
    for epoch, (factor, active) in enumerate([([1.0, 0.5], [1.0, 1.0]),
                                              ([0.5, 0.5], [1.0, 0.0])]):
        rng = np.random.RandomState(epoch)
        idx, mask = (t.numpy() for t in pt._batch_tables(
            [rng.permutation(ix) for ix in train], BATCH))
        jp, jbs, jopt, tm = train_epoch(
            jp, jbs, jopt, jnp.asarray(images), jnp.asarray(labels), idx,
            mask, jnp.asarray(factor, jnp.float32),
            jnp.asarray(active, jnp.float32), epoch)
        vm = eval_epoch(jp, jbs, jnp.asarray(images), jnp.asarray(labels),
                        v_idx, v_mask)
        jlogs += [jax.vmap(jax_M.compute_metrics)(tm),
                  jax.vmap(jax_M.compute_metrics)(vm)]
    for got, want in zip(logs, jlogs):
        for t in range(2):
            for key in ("loss", "accuracy", "auc"):
                np.testing.assert_allclose(got[t][key],
                                           float(want[key][t]), rtol=1e-5,
                                           atol=1e-7, err_msg=key)
    lr = spec.phases[0].lr
    steps = 2 * len(idx)
    for t in range(2):
        sd = state_dict_from_flax({
            "params": jax.tree.map(lambda a: np.asarray(a[t]), jp),
            "batch_stats": jax.tree.map(lambda a: np.asarray(a[t]), jbs)})
        for k, want in sd.items():
            got = {**p, **b}[k][t].detach()
            if "running" in k:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7,
                                           msg=k)
            else:
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=2 * lr * steps, msg=k)


def test_adam_alpha_table_equals_host_values():
    """Each entry, t = 1 ... 10^4, equals Keras Adam's float32 host value
    (``sqrt(1 - b2^t) / (1 - b1^t)`` in numpy float32 scalars); steps past
    the table read 1.0, which the formula gives there too."""
    table = adam_alpha_table()
    one, b1, b2 = np.float32(1), np.float32(0.9), np.float32(0.999)

    def host(t):
        t = np.float32(t)
        return np.float32(np.sqrt(one - b2 ** t) / (one - b1 ** t))
    for t in range(1, 10 ** 4 + 1):
        assert table[t] == host(t), t
    steps = torch.tensor([1, 2, 10 ** 4, len(table) - 1, len(table),
                          10 ** 5, 10 ** 6])
    got = adam_alpha(steps, 0.9, 0.999).numpy()
    for t, g in zip(steps.tolist(), got):
        assert g == host(t), t
    assert table[-1] == 1.0 and table[-2] != 1.0


def test_streamed_epoch_equals_cached_epoch():
    """The same epochs from host memory (``FrameArrays``: host batches,
    the pinned staging, the one-ahead copy and the per-shape program of
    the streaming tier) and from the device cache (the graphed epoch's
    runner): bit for bit."""
    spec = build_model("cnn0", HP, SHAPE, 2)
    images, labels = frames(SHAPE)
    paths = [str(i) for i in range(N)]
    out = []
    for ds, mode in ((FrameArrays(images, labels, paths),
                      "streamed-uncaptured"),
                     (DeviceCachedDataset.from_arrays(images, labels, "cpu"),
                      "uncaptured")):
        trainer = Trainer(spec, seed=5, aug_config=AUG, device="cpu")
        out.append((trainer, drive(trainer, ds, ds, False, mode)))
    (streamed, s_logs), (cached, c_logs) = out
    assert s_logs == c_logs
    assert_same_state(streamed, cached)


def test_capture_counts_launches_per_replay():
    """The kernels' counts leave out what a capture calls (it launches
    nothing) and add it once per replay, kernel by kernel; calls outside a
    capture count as they are made."""
    from ab_line_classifier_torch.ops import launches

    start = launches.counts()
    with launches.capture() as captured:
        launches.add("preprocess")
        launches.add("depthwise", 10)
        launches.add("epilogue", 7)
        launches.add("bn_act", 39)
    assert captured.per_replay == {"preprocess": 1, "depthwise": 10,
                                   "epilogue": 7, "bn_act": 39}
    assert launches.counts() == start
    launches.add("depthwise", 2)   # eager calls
    captured.replayed()
    captured.replayed(3)
    assert launches.counts() == {"preprocess": start["preprocess"] + 4,
                                 "depthwise": start["depthwise"] + 42,
                                 "epilogue": start["epilogue"] + 28,
                                 "bn_act": start["bn_act"] + 156}


def test_capture_pauses_the_cycle_collector():
    """No cyclic collection runs inside a capture (it could destroy a dead
    trainer's graph mid-capture); the collector's state comes back after,
    also when the capture raises."""
    import gc

    from ab_line_classifier_torch.ops import launches

    assert gc.isenabled()
    with launches.capture():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError), launches.capture():
        raise RuntimeError("capture failed")
    assert gc.isenabled()
    gc.disable()
    try:
        with launches.capture():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
