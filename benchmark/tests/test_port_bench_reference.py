"""The plain reference against the program on the CPU at a tiny size, the
comparison that decides ``correct`` with the timed path broken underneath,
and the control."""

import importlib
import json
import time

import pytest
import torch

import reference
import run as bench_run
from harness import cells, gen, weights
from reference import augment as ref_aug
from reference import preprocess as ref_pre

CPU = torch.device("cpu")
TINY = {"serve": dict(chunk=4, pool_chunks=2, frame_hw=[96, 128],
                      trace_seconds=0.01),
        "fit": dict(train_frames=24, batch=8)}


def tiny(name):
    cell = cells.load(name)
    cell.traffic.update(TINY[cell.traffic["driver"]])
    return cell


def drive(cell, seed=2**32 + 3, traced=False):
    """The rest of a run on the CPU (no look for a card): the driver, then
    the result line."""
    driver = importlib.import_module(f"harness.{cell.traffic['driver']}")
    outcome = driver.run(cell, seed, 0.2, traced, CPU, time.perf_counter())
    return bench_run.result_line(cell, outcome, traced, CPU), outcome


def port_spec(cfg):
    from ab_line_classifier_torch.models import build_model
    return build_model(cfg["model_def"], cfg["hparams"],
                       tuple(cfg["input_shape"]), cfg["n_classes"],
                       mixed_precision=False)


@pytest.mark.parametrize("name", ["cutoffvgg16", "mobilenetv2"])
def test_reference_model_is_the_programs_in_float32(name):
    cfg = json.load(open(f"{cells.BENCH_DIR}/configs/{name}.json"))
    ref = reference.build(cfg)
    state = weights.make(ref, cfg, 7, CPU)
    ref.load_state_dict(state)
    port = port_spec(cfg).module()
    assert set(port.state_dict()) == set(state)
    port.load_state_dict(state)
    x = ref_pre.scale_input(gen.frames(gen.generator(1, "frames", CPU), 3,
                                       (128, 128), (0.15, 1.0), CPU),
                            cfg["preprocess_mode"])
    with torch.no_grad():
        want = torch.softmax(ref(x)[0], -1)
        got = port.eval()(x)
    assert torch.allclose(got, want, atol=2e-6), (got, want)
    assert float(want[:, 1].std()) > 1e-3  # the frames are told apart


@pytest.mark.parametrize("mode", ["caffe", "tf"])
def test_reference_preprocess_is_b1s(mode):
    from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames
    frames = gen.frames(gen.generator(2, "frames", CPU), 2, (96, 160),
                        (0.15, 1.0), CPU)
    cfg = {"input_shape": [128, 128, 3], "resize_mode": "tf",
           "preprocess_mode": mode}
    want = ref_pre.model_input(frames, cfg)
    got = preprocess_frames(frames, out_hw=(128, 128), preprocess_mode=mode,
                            out_dtype=torch.float32)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


def test_reference_augmentation_is_the_programs():
    from ab_line_classifier_torch.data.augment import (
        affine_params_from_config, augment_batch)
    aug = json.load(open(f"{cells.BENCH_DIR}/traffic/fit-cached.json")
                    )["augmentation"]
    images = gen.frames(gen.generator(3, "frames", CPU), 16, (128, 128),
                        (0.15, 1.0), CPU)
    got = augment_batch(images.float(), torch.Generator().manual_seed(9),
                        **affine_params_from_config(aug))
    want = ref_aug.augment(images, torch.Generator().manual_seed(9),
                           ref_aug.params_from_config(aug))
    assert torch.allclose(got, want, atol=2e-3, rtol=0), float(
        (got - want).abs().max())


@pytest.mark.parametrize("name", ["cutoffvgg16-serve-study",
                                  "mobilenetv2-serve-study",
                                  "cutoffvgg16-fit-cached"])
def test_a_sound_run_is_correct(name):
    result, outcome = drive(tiny(name), traced=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert outcome.view.trace is not None


def test_an_altered_answer_is_caught(monkeypatch):
    from ab_line_classifier_torch.predict.predict import Predictor
    forward = Predictor.forward

    def altered(self, frames):
        out = forward(self, frames).clone()
        out[0] = (out[0] < out[0].max()).to(out.dtype)  # another class, sure
        return out

    monkeypatch.setattr(Predictor, "forward", altered)
    result, outcome = drive(tiny("mobilenetv2-serve-study"))
    assert not result["correct"]
    assert outcome.failed > 0


def test_a_state_left_unchanged_is_caught(monkeypatch):
    from ab_line_classifier_torch.train.loop import Trainer
    core = Trainer._train_core

    def unchanged(self, *args):
        before = [p.detach().clone() for p in self.module.parameters()]
        loss = core(self, *args)
        with torch.no_grad():
            for p, b in zip(self.module.parameters(), before):
                p.copy_(b)
        return loss

    monkeypatch.setattr(Trainer, "_train_core", unchanged)
    result, _ = drive(tiny("cutoffvgg16-fit-cached"))
    assert not result["correct"]
    assert result["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_an_altered_validation_answer_is_caught(monkeypatch):
    from ab_line_classifier_torch.train.loop import Trainer
    eval_step = Trainer.eval_step

    def altered(self, images, labels, mask, metrics):
        def flip(module, args, out):  # the first frame's logits swapped
            out[0] = out[0].flip(-1) + 1.0

        handle = self.module.register_forward_hook(flip)
        try:
            eval_step(self, images, labels, mask, metrics)
        finally:
            handle.remove()

    monkeypatch.setattr(Trainer, "eval_step", altered)
    result, _ = drive(tiny("cutoffvgg16-fit-cached"))
    gap = result["checks"]["val_logit_gap"]
    assert not result["correct"] and gap["value"] > gap["limit"]


def test_a_late_step_left_unchanged_is_caught(monkeypatch):
    """The window's later replays are held too: a fault that starts after
    set-up's epochs shows in the check epoch's steps."""
    from ab_line_classifier_torch.train.loop import Trainer
    core = Trainer._train_core
    calls = []

    def late(self, *args):
        calls.append(1)
        before = [p.detach().clone() for p in self.module.parameters()]
        loss = core(self, *args)
        if len(calls) > 6:  # after set-up's epoch and the window's first
            with torch.no_grad():
                for p, b in zip(self.module.parameters(), before):
                    p.copy_(b)
        return loss

    monkeypatch.setattr(Trainer, "_train_core", late)
    result, _ = drive(tiny("cutoffvgg16-fit-cached"))
    assert not result["correct"]
    assert result["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_half_a_batch_left_out_is_caught(monkeypatch):
    from ab_line_classifier_torch.train import objective
    forward_loss = objective.forward_loss

    def half(module, reg_layers, reg_lambdas, x, labels_oh, mask, class_w,
             train, generator=None, denom=None):
        if train:
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
        return forward_loss(module, reg_layers, reg_lambdas, x, labels_oh,
                            mask, class_w, train, generator, denom)

    monkeypatch.setattr(objective, "forward_loss", half)
    result, _ = drive(tiny("cutoffvgg16-fit-cached"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["mobilenetv2-serve-study",
                                  "cutoffvgg16-fit-cached"])
def test_the_control_is_not_correct(name):
    import control
    cell = tiny(name)
    if cell.traffic["driver"] == "serve":  # the widest gap wants frames
        cell.traffic.update(chunk=64, frame_hw=[480, 640])
    got = control.readings(cell, 2**32 + 11, CPU)
    failed = {k: any(v > cell.limits[n] for n, v in nums.items())
              for k, nums in got.items() if k != "detail"}
    assert all(failed.values()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cutoffvgg16-serve-study",
                                  "mobilenetv2-serve-study",
                                  "cutoffvgg16-fit-cached"])
def test_the_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    import control
    cell = cells.load(name)
    for seed in (31, 32, 33):
        got = control.readings(cell, seed, torch.device("cuda", 0))
        for fault, nums in got.items():
            if fault == "detail":
                continue
            assert any(v > cell.limits[n] for n, v in nums.items()), (
                seed, fault, nums)
