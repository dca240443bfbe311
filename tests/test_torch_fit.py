"""PyTorch port, the fit loop: ``CallbackState`` (Keras EarlyStopping +
ReduceLROnPlateau) fuzzed against the JAX package's, exactly; ``Trainer.fit``
over both phases of a small cutoffvgg16 against the JAX package's
``Trainer.fit`` on the same device-cached frames and weights; and resume:
a run interrupted mid-fit and continued with ``resume=True`` ends with the
weights of an uninterrupted run, bit for bit on the CPU.

The fit: 16x16 frames, batch 16, 24 training frames (the second batch of
each epoch padded with wraparound rows), validation on the same frames with
the labels flipped, so the validation loss rises as the training loss
falls: each phase improves once, ReduceLROnPlateau halves the rate at the
next epoch and EarlyStopping (patience 2) stops at the one after and
restores the phase's best weights. No augmentation, dropout 0 (the random
streams cannot match). Tolerances: per-epoch losses within 1e-4 relative,
learning rates within 1e-6 relative, the stopping epochs exact, the
returned weights within 1e-5 absolute (float32; a few steps of Adam and
RMSprop, whose early steps are ``lr * sign(g)``: the decisions are checked
to lie well clear of float32 noise).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_train_step import scaled_variables

from ab_line_classifier_tpu.data.pipeline import (
    DeviceCachedDataset as JaxCachedDataset)
from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.train.loop import CallbackState as JaxCallbacks
from ab_line_classifier_tpu.train.loop import Trainer as JaxTrainer
from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from ab_line_classifier_torch.train.loop import CallbackState, Trainer
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

SHAPE = (16, 16, 3)
HPARAMS = dict(ZOO_HPARAMS["cutoffvgg16"], DROPOUT=0.0, EXTRACT_EPOCHS=3,
               LR_EXTRACT=1e-3, LR_FINETUNE=1e-5)
EPOCHS, PATIENCE, BATCH, N = 5, 2, 16, 24


def test_callback_state_matches_jax():
    """Random val_loss sequences with exact repeats and steps across the
    plateau's 1e-4 min_delta: the same improvements, stops and learning
    rates, epoch by epoch."""
    rng = np.random.RandomState(0)
    for _ in range(40):
        patience = int(rng.randint(1, 7))
        seq = np.round(rng.rand(25) * 0.01 / 5e-5) * 5e-5 + 0.2
        mine = CallbackState(patience=patience,
                             plateau_patience=max(1, patience // 2))
        ref = JaxCallbacks(patience=patience,
                           plateau_patience=max(1, patience // 2))
        lr_m = lr_r = 1e-3
        for v in seq:
            got, want = mine.update(float(v), lr_m), ref.update(float(v),
                                                                 lr_r)
            assert got == want
            if got[2] is not None:
                lr_m = lr_r = got[2]
            if got[1]:
                break


class _Frames:
    """The FrameDataset surface the JAX device cache reads: a frames table
    and ``load_all``."""

    def __init__(self, images, labels):
        self.images, self._labels = images, labels
        self.df = pd.DataFrame({"Frame Path": [f"{i}.png"
                                               for i in range(len(labels))],
                                "Class": labels})
        self.img_dim = images.shape[1:3]

    def __len__(self):
        return len(self._labels)

    def load_all(self):
        return self.images, self._labels


def frames():
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (N,) + SHAPE).astype(np.uint8)
    labels = rng.randint(0, 2, N).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_epoch_batches_match_jax(shuffle, drop_remainder):
    """The device cache's epochs (batch 16 of 24 frames: one partial
    batch) give the JAX package's rows, masks, indices and pixels, shuffled
    or not, with the partial batch padded or dropped."""
    images, labels = frames()
    want = list(JaxCachedDataset(_Frames(images, labels)).batches(
        BATCH, shuffle=shuffle, seed=7, drop_remainder=drop_remainder))
    got = list(DeviceCachedDataset.from_arrays(images, labels, "cpu").batches(
        BATCH, shuffle=shuffle, seed=7, drop_remainder=drop_remainder))
    assert len(got) == len(want) == (1 if drop_remainder else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.images.numpy(), np.asarray(w.images))
        np.testing.assert_array_equal(g.labels.numpy(), np.asarray(w.labels))


@pytest.fixture(scope="module")
def fits():
    images, labels = frames()
    jax_spec = jax_build_model("cutoffvgg16", HPARAMS, SHAPE, 2,
                               total_epochs=EPOCHS)
    spec = build_model("cutoffvgg16", HPARAMS, SHAPE, 2, total_epochs=EPOCHS)
    v = scaled_variables(jax_spec, spec)

    jtr = JaxCachedDataset(_Frames(images, labels))
    jva = JaxCachedDataset(_Frames(images, 1 - labels))
    jvars, jhist = JaxTrainer(jax_spec, seed=0).fit(
        jtr, jva, batch_size=BATCH, epochs=EPOCHS, patience=PATIENCE,
        variables={"params": v["params"]}, verbose=False)

    tr = DeviceCachedDataset.from_arrays(images, labels, "cpu")
    va = DeviceCachedDataset.from_arrays(images, 1 - labels, "cpu")
    state, hist = Trainer(spec, seed=0, device="cpu").fit(
        tr, va, batch_size=BATCH, epochs=EPOCHS, patience=PATIENCE,
        variables=state_dict_from_flax(v), verbose=False)
    return jvars, jhist, state, hist


def test_fit_history_matches_jax(fits):
    _, jhist, _, hist = fits
    assert [(h.epoch, h.phase) for h in hist] == [
        (h.epoch, h.phase) for h in jhist]
    # Each phase: an improvement, then a rate cut, then the stop.
    assert [h.phase for h in hist] == ["extract"] * 3 + ["finetune"] * 3
    for h, j in zip(hist, jhist):
        for part in ("train", "val"):
            assert getattr(h, part)["loss"] == pytest.approx(
                getattr(j, part)["loss"], rel=1e-4)
        assert h.lr == pytest.approx(j.lr, rel=1e-6)
    val = [h.val["loss"] for h in hist]
    for phase in (val[:3], val[3:]):
        assert phase[1] - phase[0] > 1e-3 and phase[2] - phase[0] > 1e-3
    lrs = [h.lr for h in hist]
    assert lrs[2] == pytest.approx(lrs[1] / 2) and lrs[5] == pytest.approx(
        lrs[4] / 2)


def test_fit_returns_jax_weights(fits):
    jvars, _, state, _ = fits
    got = flax_from_state_dict(state)["params"]
    for layer, leaves in jvars["params"].items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got[layer][leaf], np.asarray(want),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{layer}.{leaf}")


class _Interrupt(Exception):
    pass


class _StopAt:
    def __init__(self, epoch):
        self.epoch = epoch

    def on_epoch_end(self, epoch, state):
        if epoch == self.epoch:
            raise _Interrupt


@pytest.mark.parametrize("stop_epoch", [2, 4])
def test_resume_reaches_the_uninterrupted_weights(tmp_path, stop_epoch):
    """Augmentation and dropout on (the per-step generators), a run killed
    after epoch ``stop_epoch - 1`` (the last checkpoint) and resumed."""
    images, labels = frames()
    hp = dict(HPARAMS, DROPOUT=0.3, EXTRACT_EPOCHS=3)
    spec = build_model("cutoffvgg16", hp, SHAPE, 2, total_epochs=6)
    aug = {"ZOOM_RANGE": 0.1, "ROTATION_RANGE": 45, "HORIZONTAL_FLIP": True,
           "WIDTH_SHIFT_RANGE": 0.2, "HEIGHT_SHIFT_RANGE": 0.2,
           "BRIGHTNESS_RANGE": 0.3}
    tr = DeviceCachedDataset.from_arrays(images, labels, "cpu")
    va = DeviceCachedDataset.from_arrays(images[:8], labels[:8], "cpu")

    def fit(**kw):
        return Trainer(spec, seed=3, aug_config=aug, device="cpu").fit(
            tr, va, batch_size=BATCH, epochs=6, patience=10, verbose=False,
            **kw)

    want, whist = fit()
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(_Interrupt):
        fit(checkpoint_dir=ckpt, callbacks=[_StopAt(stop_epoch)])
    got, hist = fit(checkpoint_dir=ckpt, resume=True)
    assert hist[0].epoch == stop_epoch and len(whist) == 7
    assert hist[-1].val == whist[-1].val
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
