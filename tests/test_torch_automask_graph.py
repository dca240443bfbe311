"""PyTorch port, the auto-masking chain as one program per sampled-clip
shape (``data/auto_masking.py::UnetSegmentation.clip_mask``): on the card a
CUDA graph per key, here on the CPU the same body uncaptured, against the
JAX package's jitted ``UnetSegmentation`` (its U-Net predict,
``clean_binary_masks`` and ``majority_average_mask``).

The same numpy-seeded fan frames and U-Net weights (carried across by the
weight bridge) go through both packages at two source sizes (96x128 and
200x240), with 11, 10 and 7 sampled frames, RGB and gray. Masks and
bounding boxes must equal JAX's ``clip_mask``, with two stated
exceptions, each counted and printed:

* a JAX U-Net probability within 1e-5 of the 0.4 threshold may land on
  the other side in the port (the forwards agree within 1e-5,
  ``tests/test_torch_automask.py``); where one exists, the chain after the
  threshold is held on JAX's own probabilities;
* with an even number of frames, an exact tie of the majority vote
  (window sum == 12.5 n) may differ: JAX takes it on a float32 mean that
  rounds it either way, the port on the integer sum (documented in
  ``ops/morphology.py``).

The program's body against the port's own eager chain is exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_automask import BAND, PROB_ATOL, beam_frames, write_mp4

from ab_line_classifier_tpu.data import auto_masking as jax_am
from ab_line_classifier_torch.data import auto_masking as torch_am
from ab_line_classifier_torch.models import unet as torch_unet
from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.ops import morphology as TM
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import flax_from_state_dict

SIZES = ((96, 128), (200, 240))
SAMPLED = (11, 10, 7)
# U-Net weight seeds whose masks keep 45-55% of these fans (seed 3 is
# tests/test_torch_automask.py's); many seeds give all-ones masks, on
# which an equality would hold nothing.
SEEDS = (3, 8)


def clip(n, hw, gray, seed):
    """``n`` uint8 fan frames of ``hw``: RGB, or their green channel."""
    frames = beam_frames(n, hw, seed)
    return np.ascontiguousarray(frames[..., 1]) if gray else frames


def port_segmentation(state):
    seg = torch_am.UnetSegmentation(device="cpu")
    seg.model.load_state_dict(state)
    return seg


@pytest.fixture(scope="module")
def segmenters():
    state = torch_unet.seeded_unet_state(16, SEEDS[0])
    jseg = jax_am.UnetSegmentation()
    jseg.variables = flax_from_state_dict(state)
    return jseg, port_segmentation(state)


def chain_ties(probs, hw):
    """Exact ties of the majority vote of the chain on ``probs``."""
    binary128 = torch.from_numpy((probs > 0.4).astype(np.float32))
    support = (torch_image.linear_resize(binary128, hw) > 0).float()
    erode, dilate = torch_am.kernel_sizes(hw[0])
    cleaned = TM.clean_binary_masks(support, erode_size=erode,
                                    dilate_size=dilate)
    window = TM._window_sum(cleaned.sum(0, keepdim=True), 5)[0].numpy()
    return 2 * window == 25 * len(probs)


@pytest.mark.parametrize("n", SAMPLED)
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("hw", SIZES, ids=["96x128", "200x240"])
def test_program_matches_jax_clip_mask(segmenters, hw, gray, n):
    jseg, tseg = segmenters
    frames = clip(n, hw, gray, seed=hw[0] + n)
    want_p = np.asarray(jseg.predict_masks(frames))
    got_p = tseg.predict_masks(frames).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROB_ATOL)
    flips = (got_p > 0.4) != (want_p > 0.4)
    near = np.abs(want_p - 0.4) < BAND
    assert not (flips & ~near).any()

    want_mask, want_box = jseg.clip_mask(frames, hw)
    got_mask, got_box = tseg.clip_mask(frames, hw)
    assert got_mask.shape == hw and got_mask.dtype == torch.float32
    band = int(near.sum())
    # Within the band the port's threshold may flip: the chain after it is
    # held on JAX's probabilities, the program on the port's own chain.
    held = got_mask if band == 0 else tseg.mask_from_probs(
        torch.from_numpy(want_p.copy()), hw)
    if band:
        assert torch.equal(got_mask, tseg.eager(frames, hw))
    ties = chain_ties(want_p, hw)
    differ = held.numpy() != want_mask
    assert not (differ & ~ties).any()
    if n % 2:
        assert not ties.any()
    if not differ.any():
        box = got_box if band == 0 else list(TM.bounding_box(held))
        assert box == list(want_box)
    share = float(want_mask.mean())
    assert 0.05 < share < 0.95, share
    print(f"{hw} {'gray' if gray else 'rgb'} n={n}: {band} JAX "
          f"probabilities within {BAND} of 0.4, {int(ties.sum())} exact "
          f"ties, {int(differ.sum())} pixels differ")


def test_program_equals_its_eager_chain_across_calls_and_shapes():
    """Clips of three keys in turn, each key called more than once: every
    mask equal to ``.eager`` of its frames, and a mask already returned
    unchanged by later calls (clones of the fixed output)."""
    seg = port_segmentation(torch_unet.seeded_unet_state(16, SEEDS[1]))
    calls = [((96, 128), False, 11, 1), ((96, 128), False, 11, 2),
             ((200, 240), True, 10, 3), ((96, 128), False, 11, 1),
             ((200, 240), True, 10, 4), ((96, 128), True, 7, 5),
             ((96, 128), False, 11, 6)]
    kept = []
    for hw, gray, n, seed in calls:
        frames = clip(n, hw, gray, seed)
        mask, box = seg.clip_mask(frames, hw)
        want = seg.eager(frames, hw)
        assert torch.equal(mask, want)
        assert box == list(TM.bounding_box(want))
        kept.append((mask, mask.clone()))
    assert all(torch.equal(m, copy) for m, copy in kept)
    assert not torch.equal(kept[0][0], kept[1][0])
    assert torch.equal(kept[0][0], kept[3][0])
    assert len(seg.summaries()) == 3


def test_one_program_per_key():
    """Three clips of two shapes build two programs; the edge-preserve
    kernel is part of the key, a tensor input of the same shape is not."""
    seg = port_segmentation(torch_unet.seeded_unet_state(16, SEEDS[1]))
    assert seg.graph_mode == "uncaptured"
    a = clip(11, (96, 128), False, 1)
    seg.clip_mask(a, (96, 128))
    seg.clip_mask(clip(11, (96, 128), False, 2), (96, 128))
    seg.clip_mask(clip(10, (96, 128), False, 3), (96, 128))
    assert sorted(seg.summaries()) == [
        "10x96x128x3 to 96x128, erode 4, dilate 4",
        "11x96x128x3 to 96x128, erode 4, dilate 4"]
    seg.clip_mask(torch.from_numpy(a), (96, 128))
    assert len(seg.summaries()) == 2
    seg.clip_mask(a, (96, 128), edge_preserve=0.9)
    assert "11x96x128x3 to 96x128, erode 9, dilate 4" in seg.summaries()
    for summary in seg.summaries().values():
        assert summary["mode"] == "uncaptured"
        assert summary["captured_launches"] is None


def test_load_after_a_program_ran(tmp_path):
    """``load()`` after a program ran: a checkpoint of the same width is
    copied into the model in place (the program kept, reading the new
    weights); one of another width replaces the model and drops every
    program. Either way ``clip_mask`` equals a fresh segmentation's."""
    seg = port_segmentation(torch_unet.seeded_unet_state(16, SEEDS[0]))
    frames = clip(11, (96, 128), False, 7)
    before, _ = seg.clip_mask(frames, (96, 128))
    model = seg.model

    new = torch_unet.seeded_unet_state(16, SEEDS[1])
    seg.load(torch_ckpt.save_model(str(tmp_path / "same"), new,
                                   {"model_name": "unet"}))
    assert seg.model is model and len(seg.summaries()) == 1
    got, box = seg.clip_mask(frames, (96, 128))
    want, want_box = port_segmentation(new).clip_mask(frames, (96, 128))
    assert torch.equal(got, want) and box == want_box
    assert not torch.equal(got, before)

    narrow = torch_unet.seeded_unet_state(8, 8)
    seg.load(torch_ckpt.save_model(str(tmp_path / "narrow"), narrow,
                                   {"model_name": "unet"}))
    assert seg.model is not model and seg.model.base_filters == 8
    assert seg.summaries() == {}
    fresh = torch_am.UnetSegmentation(base_filters=8, device="cpu")
    fresh.model.load_state_dict(narrow)
    got, box = seg.clip_mask(frames, (96, 128))
    want, want_box = fresh.clip_mask(frames, (96, 128))
    assert torch.equal(got, want) and box == want_box


def _refuse(*_, **__):
    raise AssertionError("a host-device copy or a sync in the program body")


@contextlib.contextmanager
def no_host_traffic():
    """Host -> device copies and device -> host reads raise inside."""
    patches = [(torch, name) for name in ("as_tensor", "from_numpy",
                                          "tensor")]
    patches += [(torch.Tensor, name) for name in (
        "item", "tolist", "numpy", "cpu", "__float__", "__int__",
        "__bool__")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in patches]
    try:
        for owner, name in patches:
            setattr(owner, name, _refuse)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


@pytest.mark.parametrize("hw,gray,n", [((96, 128), False, 11),
                                       ((200, 240), True, 10)])
def test_program_body_is_capture_safe(hw, gray, n):
    """A program's body after its first call copies nothing from the host
    and reads nothing back: what a CUDA graph's capture needs (the blur's
    taps, the resize weights and the ellipses are made on the device
    once; the erode's threshold is summed on the host)."""
    seg = port_segmentation(torch_unet.seeded_unet_state(16, SEEDS[1]))
    frames = clip(n, hw, gray, 11)
    want, _ = seg.clip_mask(frames, hw)
    (_, out, step), = seg._programs.values()
    with torch.inference_mode():
        out.zero_()
    with no_host_traffic():
        step.body()
    assert torch.equal(out, want)
    with no_host_traffic(), pytest.raises(AssertionError):
        torch.as_tensor(np.zeros(1))


def test_predict_replays_one_program_per_clip_shape(tmp_path, caplog):
    """``predict`` (the auto-mask CLI) over three mp4s of two sampled
    shapes runs two programs and logs the path they took, and each clip's
    ``mask.jpg`` is the eager chain's mask of its sampled frames."""
    import logging

    import cv2

    clips, out = tmp_path / "clips", tmp_path / "masked"
    clips.mkdir()
    lengths = {"c0": 20, "c1": 21, "c2": 20}   # every 2nd frame: 10, 11, 10
    for name, n in lengths.items():
        write_mp4(str(clips / f"{name}.mp4"), n_frames=n, seed=n)
    seg = port_segmentation(torch_unet.seeded_unet_state(16, SEEDS[1]))
    with caplog.at_level(logging.INFO):
        seg.predict(str(clips), str(out))
    assert "Auto-mask programs: uncaptured" in caplog.text
    assert sorted(k.split(" ")[0] for k in seg.summaries()) == [
        "10x96x128x3", "11x96x128x3"]
    for name, n in lengths.items():
        cap = cv2.VideoCapture(str(clips / f"{name}.mp4"))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1].copy())
        cap.release()
        want = seg.eager(np.stack(frames[::2]), (96, 128)).numpy()
        written = cv2.imread(str(out / name / "mask.jpg"),
                             cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(written > 127, want > 0)
        assert len(list((out / name).glob("*.jpg"))) == n + 1
