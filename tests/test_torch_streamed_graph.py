"""PyTorch port, the streamed per-batch steps as one program per batch
shape (``Trainer.run_epoch_streamed``, ``Trainer.streamed_step``): the JAX
package's jitted ``make_train_step`` and ``make_eval_step``. On the card a
CUDA graph per shape, captured once a phase; here on the CPU the same
body uncaptured.

* Two epochs a phase from host memory (``FrameArrays``, the last batch
  padded) through the programs, against the same epochs op by op
  (``Trainer.run_epoch_per_step``): bit-equal (``torch.equal``) in
  parameters, batch-norm statistics, optimizer state and metrics, with
  augmentation and dropout on and the rate halved between the epochs;
  cnn0 (batch norms that train), a cut mobilenetv2 (the depthwise layers)
  and a cutoffvgg16 at 16x16 across its extract -> finetune boundary.
* A program's body makes no host copy and no host read: ``as_tensor``,
  ``from_numpy``, ``tensor``, ``item``, ``tolist``, ``__float__`` and the
  rest raise inside it, and it still takes the op-by-op step.
* Against the JAX package in float32, on the same numpy-seeded weights
  (carried across by ``utils/jax_params.py``) and batches: the streamed
  evaluation steps' metrics against ``make_eval_step``'s within 1e-5
  relative (``tests/test_torch_train_step.py``'s ``RTOL``); one streamed
  training step, augmentation and dropout off, against
  ``make_train_step`` by ``tests/test_torch_train_step.py``'s rule.
* Programs are keyed by shape and kind; a phase drops its training
  programs; ``training_throughput_benchmark`` times the program and says
  which path it took.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_automask_graph import no_host_traffic
from test_torch_graph_epoch import (VGG_HP, assert_same_state, drive,
                                    frames)
from test_torch_train_step import (CLASS_WEIGHT, batch, check_metrics,
                                   check_update, grads64, jax_step,
                                   scaled_variables, specs)
from test_torch_trial_parallel import AUG, BATCH, HP, SHAPE

from ab_line_classifier_tpu.ops import metrics as jax_M
from ab_line_classifier_tpu.train.loop import Trainer as JaxTrainer
from ab_line_classifier_torch.data.pipeline import FrameArrays
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.ops import metrics as M
from ab_line_classifier_torch.predict import benchmark
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

MBV2_HP = dict(ZOO_HPARAMS["mobilenetv2"], DROPOUT=0.2, CUTOFF_IDX=53,
               FREEZE_IDX=-1)


def _spec(name):
    if name == "cnn0":
        return build_model("cnn0", HP, SHAPE, 2), SHAPE
    if name == "mobilenetv2":
        return build_model("mobilenetv2", MBV2_HP, SHAPE, 2), SHAPE
    return (build_model("cutoffvgg16", VGG_HP, (16, 16, 3), 2,
                        total_epochs=4), (16, 16, 3))


def _arrays(shape, n=None):
    images, labels = frames(shape)
    n = n or len(labels)
    return FrameArrays(images[:n], labels[:n], [str(i) for i in range(n)])


@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2", "cutoffvgg16"])
def test_streamed_program_equals_the_op_by_op_epoch(name):
    spec, shape = _spec(name)
    train_ds, val_ds = _arrays(shape), _arrays(shape, 20)
    runs = []
    for per_step in (False, True):
        trainer = Trainer(spec, seed=3, aug_config=AUG,
                          class_weight={0: 0.8, 1: 1.3}, device="cpu")
        mode = "per-step" if per_step else "streamed-uncaptured"
        runs.append((trainer, drive(trainer, train_ds, val_ds, per_step,
                                    mode)))
    (streamed, got), (eager, want) = runs
    assert got == want
    assert_same_state(streamed, eager)
    summaries = streamed.streamed_summaries()
    assert sorted(summaries) == [f"eval {BATCH}x{shape[0]}x{shape[1]}x3",
                                 f"train {BATCH}x{shape[0]}x{shape[1]}x3"]
    assert all(s["mode"] == "uncaptured" and s["capture_seconds"] is None
               for s in summaries.values())
    assert not eager.streamed_programs


def _host_batches(shape, seeds):
    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        out.append((torch.from_numpy(rng.randint(
            0, 256, (BATCH,) + shape).astype(np.uint8)),
            torch.from_numpy(rng.randint(0, 2, BATCH).astype(np.int32)),
            torch.from_numpy((np.arange(BATCH) < 13).astype(np.float32))))
    return out


@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
@pytest.mark.parametrize("train", [True, False])
def test_program_body_makes_no_host_sync(name, train):
    """The second step's body runs with every host copy and host read
    patched to raise (what a CUDA graph's capture needs); the steps equal
    two op-by-op steps."""
    spec, shape = _spec(name)
    first, second = _host_batches(shape, (1, 2))
    ref = Trainer(spec, seed=7, aug_config=AUG, device="cpu")
    got = Trainer(spec, seed=7, aug_config=AUG, device="cpu")
    for t in (ref, got):
        t.begin_phase(0, spec.phases[0])
    metrics = M.init_metrics(2)
    for b in (first, second):
        if train:
            ref.train_step(*b, metrics)
        else:
            ref.eval_step(*b, metrics)
    got.streamed_step(*first, train=train)
    (prog,) = got.streamed_programs.values()
    body = prog.step.body

    def guarded():
        with no_host_traffic():
            body()

    prog.step.body = guarded
    got.streamed_step(*second, train=train)
    assert_same_state(got, ref)
    assert (M.compute_metrics(got.streamed_metrics(train))
            == M.compute_metrics(metrics))
    with no_host_traffic(), pytest.raises(AssertionError):
        torch.as_tensor(np.zeros(1))


@pytest.mark.parametrize("name", ["cnn0", "mobilenetv2"])
def test_streamed_eval_steps_match_jax_make_eval_step(name):
    """Two evaluation batches (the second padded: 28 frames at 16)
    through the streamed program and through the JAX package's jitted
    eval step, from the same weights: metrics within RTOL."""
    jax_spec, port_spec = specs(name)
    images, labels = frames(SHAPE, seed=9)
    images, labels = images[:28], labels[:28]
    variables = scaled_variables(jax_spec, port_spec, batch(seed=5)[0])
    ds = FrameArrays(images, labels, [str(i) for i in range(28)])

    jt = JaxTrainer(jax_spec, class_weight=CLASS_WEIGHT, seed=0)
    phase = jax_spec.phases[0]
    jt._set_phase_module(phase)
    state, _ = jt.init_state(phase, variables)
    eval_step = jt.make_eval_step()
    jm = jax_M.init_metrics(2)
    for b in ds.batches(BATCH):
        jm = eval_step(state, jm, jnp.asarray(b.images),
                       jnp.asarray(b.labels), jnp.asarray(b.mask))
    want = {k: float(v) for k, v in jax_M.compute_metrics(jm).items()}

    trainer = Trainer(port_spec, class_weight=CLASS_WEIGHT, seed=0,
                      device="cpu")
    trainer.begin_phase(0, port_spec.phases[0],
                        state_dict_from_flax(variables))
    got = trainer.run_epoch(ds, BATCH, train=False)
    assert trainer.epoch_mode == "streamed-uncaptured"
    check_metrics({k: got[k] for k in want}, want)
    assert list(trainer.streamed_summaries()) == [f"eval {BATCH}x32x32x3"]


@pytest.mark.parametrize("name,phase_idx", [("cnn0", 0), ("mobilenetv2", 0),
                                            ("cutoffvgg16", 1)])
def test_streamed_train_step_matches_jax_make_train_step(name, phase_idx):
    """One training step through the streamed program (augmentation and
    dropout off, class weights, a masked partial batch) against the JAX
    package's jitted train step: metrics within RTOL, updates by the
    magnitude-aware rule, frozen tensors unmoved."""
    jax_spec, port_spec = specs(name)
    images, labels, mask = batch()
    v = scaled_variables(jax_spec, port_spec,
                         None if name == "cutoffvgg16" else batch(seed=5)[0])
    want, want_m = jax_step(jax_spec, phase_idx, v, images, labels, mask)
    trainer = Trainer(port_spec, class_weight=CLASS_WEIGHT, seed=0,
                      device="cpu")
    phase = port_spec.phases[phase_idx]
    trainer.begin_phase(phase_idx, phase, state_dict_from_flax(v))
    step = trainer.streamed_step(*(torch.from_numpy(a) for a in (
        images, labels, mask)), train=True)
    assert step.mode == "uncaptured" and trainer.step == 1
    got = flax_from_state_dict(trainer.state())
    got_m = M.compute_metrics(trainer.streamed_metrics(True))
    check_metrics({k: got_m[k] for k in want_m}, want_m)
    step_scale = 1.0 / np.sqrt(0.1) if phase.optimizer == "rmsprop" else 1.0
    check_update(v, got, want,
                 grads64(port_spec, phase_idx, v, images, labels, mask),
                 phase.lr, step_scale)


def test_programs_are_keyed_by_shape_and_phase():
    """A program per kind and batch shape; a new phase drops the training
    programs (trainability and optimizer are the phase's) and keeps the
    evaluation ones; ``fit`` releases them all."""
    spec, shape = _spec("cutoffvgg16")
    ds = _arrays(shape)
    trainer = Trainer(spec, seed=1, device="cpu")
    trainer.begin_phase(0, spec.phases[0])
    for bs in (8, 16):
        trainer.run_epoch(ds, bs, train=True)
        trainer.run_epoch(ds, bs, train=False)
    assert sorted(trainer.streamed_summaries()) == [
        "eval 16x16x16x3", "eval 8x16x16x3", "train 16x16x16x3",
        "train 8x16x16x3"]
    assert trainer.step == 3 + 2
    trainer.begin_phase(1, spec.phases[1])
    assert sorted(trainer.streamed_summaries()) == ["eval 16x16x16x3",
                                                    "eval 8x16x16x3"]
    trainer.fit(ds, ds, batch_size=16, epochs=4, verbose=False)
    assert not trainer.streamed_programs and not trainer.epoch_programs
    assert trainer.epoch_mode == "streamed-uncaptured"


def test_training_benchmark_times_the_program(monkeypatch):
    """``training_throughput_benchmark`` steps through the streamed
    program, never the op-by-op step, and reports its path."""
    def refused(*_, **__):
        raise AssertionError("the benchmark called Trainer.train_step")

    monkeypatch.setattr(Trainer, "train_step", refused)
    r = benchmark.training_throughput_benchmark(
        model_name="cnn0", batch_size=4, img_dim=(32, 32), n_warmup=1,
        n_iters=2, device="cpu", verbose=False)
    assert r["graph_mode"] == "uncaptured" and r["capture_seconds"] is None
    assert [p["graph_mode"] for p in r["phases"]] == ["uncaptured"]
    assert r["train_frames_per_sec"] > 0
