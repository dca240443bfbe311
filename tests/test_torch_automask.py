"""PyTorch port, auto-masking (``ops/image.py``'s downsample and bilinear
resize, ``models/unet.py``, ``data/auto_masking.py``, ``data/video.py``)
against the JAX package on the same numpy-seeded inputs, on the CPU.

Tolerances: the skimage downsample within 1e-5 of the data's range (/255,
what the U-Net reads; both sum the same float32 taps in another order);
the U-Net forward within 1e-5 (float32 convolutions in another order).
The mask chain thresholds the U-Net's probability at 0.4: a probability
within 1e-5 of it may land on either side in the two packages, so the
chain after the U-Net is held on the JAX package's own probabilities, and
a threshold flip between the two packages' probabilities is allowed only
inside that band. After the threshold the chain is exact: the bilinear
support, erode and dilate must be equal, and the majority vote equal
except at exact ties (window sum == 12.5 * n), each counted.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REPO_ROOT, cli_env

from ab_line_classifier_tpu.data import auto_masking as jax_am
from ab_line_classifier_tpu.data import video as jax_video
from ab_line_classifier_tpu.models import unet as jax_unet
from ab_line_classifier_tpu.ops import image as jax_image
from ab_line_classifier_torch.data import auto_masking as torch_am
from ab_line_classifier_torch.data import video as torch_video
from ab_line_classifier_torch.models import unet as torch_unet
from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.ops import morphology as TM
from ab_line_classifier_torch.utils import checkpoint as torch_ckpt
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)

PROB_ATOL = 1e-5
BAND = 1e-5


def beam_frames(n, hw, seed):
    """uint8 RGB frames of a noisy ultrasound fan on a dark background."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    ang = np.arctan2(xx - w / 2, yy + h * 0.1)
    r = np.hypot(xx - w / 2, yy + h * 0.1)
    sector = (np.abs(ang) < 0.6) & (r < h) & (r > 0.15 * h)
    f = rng.integers(0, 30, (n, h, w, 3), dtype=np.uint8)
    f[:, sector] = rng.integers(60, 256, (n, int(sector.sum()), 3),
                                dtype=np.uint8)
    return f


def segmenters(seed=3):
    state = torch_unet.seeded_unet_state(16, seed)
    j = jax_am.UnetSegmentation()
    j.variables = flax_from_state_dict(state)
    t = torch_am.UnetSegmentation(device="cpu")
    t.model.load_state_dict(state)
    return j, t


@pytest.mark.parametrize("hw", [(96, 128), (480, 640), (384, 512)])
def test_skimage_downsample_within_1e_5(hw):
    x = (np.random.default_rng(hw[0]).random((3,) + hw) * 255).astype(
        np.float32)
    want = np.asarray(jax_image.skimage_downsample(jnp.asarray(x), (128, 128)))
    got = torch_image.skimage_downsample(torch.from_numpy(x),
                                         (128, 128)).numpy()
    assert got.shape == want.shape == (3, 128, 128)
    np.testing.assert_allclose(got / 255.0, want / 255.0, rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("src,dst,antialias", [
    (128, 640, True), (128, 480, True), (128, 1080, True), (128, 1440, True),
    (128, 1920, True), (128, 96, True), (480, 128, False), (640, 128, False)])
def test_linear_resize_weights_zero_where_jax_is_zero(src, dst, antialias):
    """The support of a bilinear upsample is where the weights are > 0:
    the same zeros as ``jax.image.resize``'s, at odd multiples of 128
    too, where ``F.interpolate`` rounds its exact zeros otherwise."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    want = np.asarray(compute_weight_mat(src, dst, dst / src, 0.0,
                                         _fill_triangle_kernel, antialias))
    got = torch_image.linear_resize_weights(src, dst, antialias)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("hw", [(96, 128), (480, 640)])
def test_bilinear_support_equal_to_jax(hw):
    rng = np.random.default_rng(1)
    b128 = (rng.random((4, 128, 128)) < 0.3).astype(np.float32)
    b128[:, 40:90, 30:100] = 1.0
    want = np.asarray(jax.image.resize(
        jnp.asarray(b128), (4,) + hw, method="linear")) > 0
    got = torch_image.linear_resize(torch.from_numpy(b128), hw).numpy() > 0
    np.testing.assert_array_equal(got, want)


def test_unet_forward_within_1e_5_of_flax():
    state = torch_unet.seeded_unet_state(16, 0)
    variables = flax_from_state_dict(state)
    x = np.random.default_rng(0).random((4, 128, 128, 1)).astype(np.float32)
    want = np.asarray(jax_unet.UNet(base_filters=16).apply(variables,
                                                           jnp.asarray(x)))
    model = torch_unet.UNet(16).eval()
    model.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 128, 128, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_unet_transpose_conv_doubles_and_matches_flax_layout():
    """k = s = 2 transposed convs give exactly 2H, and the flax kernel
    ``(kh, kw, out, in)`` maps to ``ConvTranspose2d``'s ``(in, out, kh,
    kw)`` through the bridge and back unchanged."""
    flax_vars = jax_unet.UNet(base_filters=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1)))
    flax_vars = jax.tree.map(np.asarray, flax_vars)
    assert flax_vars["params"]["dec3_up"]["kernel"].shape == (2, 2, 64, 128)
    state = state_dict_from_flax(flax_vars)
    model = torch_unet.UNet(8)
    assert state["dec3_up.weight"].shape == model.dec3_up.weight.shape
    model.load_state_dict(state)
    back = flax_from_state_dict(model.state_dict())
    for layer, leaves in flax_vars["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][leaf], value)
    assert model.dec3_up(torch.zeros(1, 128, 8, 8)).shape == (1, 64, 16, 16)


def write_keras_unet_h5(path, base_filters=16, levels=4, seed=0):
    """A U-Net ``.h5`` in Keras's layout written with h5py: every layer in
    ``model_weights.attrs["layer_names"]`` (weightless ones too), kernels
    ``(kh, kw, in, out)``, transposed-conv kernels ``(kh, kw, out, in)``."""
    rng = np.random.default_rng(seed)
    layers = [("input_1", None)]
    cin = 1
    for lv in range(levels):
        f = base_filters * 2 ** lv
        layers += [(f"conv2d_{2 * lv}", (3, 3, cin, f)),
                   (f"conv2d_{2 * lv + 1}", (3, 3, f, f)),
                   (f"max_pooling2d_{lv}", None)]
        cin = f
    f = base_filters * 2 ** levels
    layers += [("conv2d_b0", (3, 3, cin, f)), ("conv2d_b1", (3, 3, f, f))]
    cin = f
    for lv in reversed(range(levels)):
        f = base_filters * 2 ** lv
        layers += [(f"conv2d_transpose_{lv}", (2, 2, f, cin)),
                   (f"concatenate_{lv}", None),
                   (f"conv2d_d{lv}a", (3, 3, 2 * f, f)),
                   (f"conv2d_d{lv}b", (3, 3, f, f))]
        cin = f
    layers.append(("conv2d_head", (1, 1, cin, 1)))
    with h5py.File(path, "w") as h:
        g = h.create_group("model_weights")
        g.attrs["layer_names"] = [n.encode() for n, _ in layers]
        for name, shape in layers:
            lg = g.create_group(name)
            if shape is None:
                lg.attrs["weight_names"] = []
                continue
            names = [f"{name}/kernel:0", f"{name}/bias:0"]
            lg.attrs["weight_names"] = [n.encode() for n in names]
            out_c = shape[2] if "transpose" in name else shape[3]
            lg.create_dataset(names[0], data=rng.normal(
                0, 0.2, shape).astype(np.float32))
            lg.create_dataset(names[1], data=rng.normal(
                0, 0.05, (out_c,)).astype(np.float32))


def test_h5_import_same_state_as_jax(tmp_path):
    path = str(tmp_path / "unet.h5")
    write_keras_unet_h5(path)
    v0 = jax_unet.UNet(base_filters=16).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 128, 128, 1)))
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, jax_unet.import_h5_unet_weights(path, v0)))
    got = torch_unet.import_h5_unet_weights(
        path, torch_unet.UNet(16).state_dict())
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    seg = torch_am.UnetSegmentation(path, device="cpu")
    assert seg.loaded
    for k, v in seg.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_h5_import_of_a_mismatched_unet_raises(tmp_path):
    path = str(tmp_path / "narrow.h5")
    write_keras_unet_h5(path, base_filters=8)
    with pytest.raises(ValueError, match="kernel shape"):
        torch_unet.import_h5_unet_weights(path,
                                          torch_unet.UNet(16).state_dict())
    shallow = str(tmp_path / "shallow.h5")
    write_keras_unet_h5(shallow, levels=3)
    with pytest.raises(ValueError, match="weighted layers"):
        torch_unet.import_h5_unet_weights(shallow,
                                          torch_unet.UNet(16).state_dict())


def test_load_checkpoint_dir_and_refuse_other_paths(tmp_path):
    state = torch_unet.seeded_unet_state(8, 1)
    d = torch_ckpt.save_model(str(tmp_path / "unet_ckpt"), state,
                              {"model_name": "unet", "base_filters": 8})
    seg = torch_am.UnetSegmentation(d, device="cpu")
    assert seg.model.base_filters == 8
    for k, v in seg.model.state_dict().items():
        assert torch.equal(v, state[k])
    with pytest.raises(FileNotFoundError):
        seg.load(str(tmp_path / "missing.pt"))


def test_segmentation_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_am.UnetSegmentation()


def _compare_masks(jseg, tseg, frames, hw):
    """``clip_mask`` of both packages: probabilities within 1e-5, threshold
    flips only inside the band, and the chain after the U-Net held on the
    JAX package's probabilities: mask equal except counted exact ties,
    bounding boxes equal where the masks are."""
    want_p = np.asarray(jseg.predict_masks(frames))
    got_p = tseg.predict_masks(frames).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROB_ATOL)
    flips = (got_p > 0.4) != (want_p > 0.4)
    assert not (flips & (np.abs(want_p - 0.4) >= BAND)).any()

    want_mask, want_box = jseg.clip_mask(frames, hw)
    got = tseg.mask_from_probs(torch.from_numpy(want_p.copy()), hw).numpy()
    binary128 = torch.from_numpy((want_p > 0.4).astype(np.float32))
    support = (torch_image.linear_resize(binary128, hw) > 0).float()
    cleaned = TM.clean_binary_masks(support,
                                    erode_size=max(int(hw[0] * (1 - 0.95)),
                                                   3),
                                    dilate_size=max(int(hw[0] * 0.05), 3))
    window = TM._window_sum(cleaned.sum(0, keepdim=True), 5)[0].numpy()
    ties = 2 * window == 25 * len(frames)
    differ = got != want_mask
    assert not (differ & ~ties).any()
    if not differ.any():
        assert TM.bounding_box(got) == tuple(want_box)
    return int(ties.sum()), int(differ.sum())


@pytest.mark.parametrize("hw", [(96, 128), (480, 640)])
def test_clip_mask_equal_to_jax(hw):
    jseg, tseg = segmenters()
    frames = beam_frames(11, hw, hw[0])
    ties, differ = _compare_masks(jseg, tseg, frames, hw)
    assert ties == 0 and differ == 0   # n = 11 is odd: no tie exists
    # An even sample reaches ties: counted, and only they may differ.
    ties, differ = _compare_masks(jseg, tseg, frames[:10], hw)
    print(f"{hw}: {ties} exact ties, {differ} differ")


def test_mask_frames_equal_to_jax():
    jseg, tseg = segmenters()
    frames = beam_frames(5, (48, 64), 9)
    mask = np.zeros((48, 64), np.float32)
    mask[5:40, 10:50] = 1
    box = list(TM.bounding_box(mask))
    for bbox in (None, box):
        want = jseg.mask_frames(frames, mask, bbox)
        got = tseg.mask_frames(frames, torch.from_numpy(mask), bbox)
        assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(want)))


def write_mp4(path, n_frames=8, hw=(96, 128), seed=0):
    import cv2
    h, w = hw
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h), True)
    for frame in beam_frames(n_frames, hw, seed):
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()


def test_mp4_to_frames_equal_to_jax(tmp_path):
    import cv2
    mp4 = str(tmp_path / "clip7.mp4")
    write_mp4(mp4, n_frames=4)
    want = jax_video.mp4_to_frames(str(tmp_path / "jax"), mp4)
    got = torch_video.mp4_to_frames(str(tmp_path / "torch"), mp4)
    assert got == want == [f"clip7_{i}.jpg" for i in range(4)]
    for name in got:
        a = cv2.imread(str(tmp_path / "jax" / name))
        b = cv2.imread(str(tmp_path / "torch" / name))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["jpg", "mp4"])
def test_automask_cli_on_cpu(tmp_path, fmt):
    """``python -m ab_line_classifier_torch.data.auto_masking --device cpu``
    on a small mp4 and a Keras-layout ``.h5``: ``mask.jpg`` and the masked
    frames (or mp4) are written, and the mask is JAX's ``clip_mask`` of
    the same sampled frames (every frame of an 8-frame clip: step 1)."""
    import cv2
    clips, out = tmp_path / "clips", tmp_path / "masked"
    clips.mkdir()
    h5 = str(tmp_path / "unet.h5")
    write_keras_unet_h5(h5, seed=4)
    write_mp4(str(clips / "clip0.mp4"), n_frames=8, hw=(96, 128), seed=2)
    r = subprocess.run(
        [sys.executable, "-m", "ab_line_classifier_torch.data.auto_masking",
         "-i", str(clips), "-o", str(out), "-m", h5, "-f", fmt,
         "--device", "cpu"], env=cli_env(), cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    clip_dir = out / "clip0"
    if fmt == "jpg":
        assert sorted(os.listdir(clip_dir)) == sorted(
            [f"{i}.jpg" for i in range(8)] + ["mask.jpg"])
    else:
        cap = cv2.VideoCapture(str(clip_dir / "clip0.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 8
        cap.release()
    written = cv2.imread(str(clip_dir / "mask.jpg"), cv2.IMREAD_GRAYSCALE)
    assert written.shape == (96, 128)

    frames = []
    cap = cv2.VideoCapture(str(clips / "clip0.mp4"))
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1].copy())
    cap.release()
    frames = np.stack(frames)
    jseg = jax_am.UnetSegmentation()
    jseg.load(h5)
    tseg = torch_am.UnetSegmentation(h5, device="cpu")
    want_p = np.asarray(jseg.predict_masks(frames))
    got_p = tseg.predict_masks(frames).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROB_ATOL)
    ambiguous = int((np.abs(got_p - 0.4) < BAND).sum())
    want, _ = (jseg.clip_mask(frames, (96, 128)) if ambiguous == 0
               else tseg.clip_mask(frames, (96, 128)))
    np.testing.assert_array_equal(written > 127, np.asarray(want) > 0)
