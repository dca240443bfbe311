"""PyTorch port, native JPEG loader (``csrc/loader.cc`` through
``data/native.py``) against the JAX package's, on the JAX package's
synthetic JPEGs (PIL-written, 96x120).

Held exactly (byte for byte): the port's ``decode_jpeg_batch`` against the
JAX package's native loader and against both packages' PIL
``FrameDataset`` frames, in ``tf`` and ``cv2`` modes, downscaled,
upscaled and to odd sizes; ``FrameDataset(use_native=True)`` batches
(shuffled, the last one padded by wraparound) and ``load_all`` against the
JAX package's. Also: a missing or corrupt file's ``RuntimeError``, the
``out`` layout check, ``use_native=True`` raising with the build's message
where the loader is unavailable, and the library rebuilt under a new hash
when its source changes (and not rebuilt when it does not).
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest

from ab_line_classifier_tpu.data import native as jax_native
from ab_line_classifier_tpu.data.pipeline import (
    FrameDataset as JaxFrameDataset)
from ab_line_classifier_tpu.data.synthetic import generate_dataset
from ab_line_classifier_torch.data import native
from ab_line_classifier_torch.data.pipeline import FrameDataset
from ab_line_classifier_torch.ops import _build

SIZES = {"down": (64, 64), "up": (130, 97), "odd": (61, 45)}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("torch_native_ws"))
    fcsv, _, fdir = generate_dataset(ws, n_patients=4, clips_per_patient=2,
                                     frames_per_clip=4, hw=(96, 120), seed=1)
    df = pd.read_csv(fcsv)
    paths = [os.path.join(fdir, p) for p in df["Frame Path"]]
    return df, fdir, paths


@pytest.fixture(scope="module")
def libs():
    """Both packages' loaders, built here (g++ and libjpeg), or a skip that
    says why, as the JAX package's own loader tests skip."""
    if not (native.native_available() and jax_native.native_available()):
        pytest.skip(f"native loader not built: {native.build_error()}")


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", ["tf", "cv2"])
def test_decode_matches_jax_and_pil(frames, libs, mode, size):
    df, fdir, paths = frames
    hw = SIZES[size]
    got = native.decode_jpeg_batch(paths, hw, mode)
    assert got.shape == (len(paths),) + hw + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_native.decode_jpeg_batch(paths, hw, mode))
    pil = FrameDataset(df, fdir, img_dim=hw, resize_mode=mode,
                       use_native=False)
    jax_pil = JaxFrameDataset(df, fdir, img_dim=hw, resize_mode=mode,
                              use_native=False)
    for i in range(len(paths)):
        np.testing.assert_array_equal(got[i], pil.load_frame(i))
        np.testing.assert_array_equal(got[i], jax_pil.load_frame(i))


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_thread_count_does_not_change_the_bytes(frames, libs, n_threads):
    _, _, paths = frames
    np.testing.assert_array_equal(
        native.decode_jpeg_batch(paths, (64, 64), n_threads=n_threads),
        jax_native.decode_jpeg_batch(paths, (64, 64), n_threads=1))


@pytest.mark.parametrize("bad", ["missing", "corrupt"])
def test_bad_file_raises_naming_it(frames, libs, tmp_path, bad):
    _, _, paths = frames
    path = str(tmp_path / "bad.jpg")
    if bad == "corrupt":
        with open(path, "wb") as f:
            f.write(b"not a jpeg at all")
    for decode in (native.decode_jpeg_batch, jax_native.decode_jpeg_batch):
        with pytest.raises(RuntimeError, match="failed on 1/2") as err:
            decode([paths[0], path], (64, 64))
        assert "bad.jpg" in str(err.value)


@pytest.mark.parametrize("out", [
    np.zeros((2, 64, 64, 3), np.float32),          # dtype
    np.zeros((2, 64, 63, 3), np.uint8),            # shape
    np.zeros((2, 64, 64, 6), np.uint8)[..., ::2],  # not contiguous
    np.zeros((3, 64, 64, 3), np.uint8),            # count
])
def test_out_layout_is_checked(frames, libs, out):
    _, _, paths = frames
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.decode_jpeg_batch(paths[:2], (64, 64), out=out)
    assert not out.any()  # nothing written


def test_decode_into_out_fills_it(frames, libs):
    _, _, paths = frames
    out = np.zeros((3, 64, 64, 3), np.uint8)
    assert native.decode_jpeg_batch(paths[:3], (64, 64), out=out) is out
    np.testing.assert_array_equal(
        out, jax_native.decode_jpeg_batch(paths[:3], (64, 64)))


@pytest.mark.parametrize("mode", ["tf", "cv2"])
def test_native_batches_equal_jax(frames, libs, mode):
    df, fdir, _ = frames
    ds = FrameDataset(df, fdir, img_dim=(48, 40), resize_mode=mode,
                      use_native=True)
    ref = JaxFrameDataset(df, fdir, img_dim=(48, 40), resize_mode=mode,
                          use_native=True)
    assert ds.use_native is True
    # 32 frames in batches of 12: the last one has 8 real rows.
    got = list(ds.batches(12, shuffle=True, seed=3))
    want = list(ref.batches(12, shuffle=True, seed=3, prefetch=0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("images", "labels", "mask", "indices"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    last = got[-1]
    np.testing.assert_array_equal(last.images[8:], last.images[:4])
    np.testing.assert_array_equal(ds.load_all()[0], ref.load_all()[0])
    pil = FrameDataset(df, fdir, img_dim=(48, 40), resize_mode=mode,
                       use_native=False)
    np.testing.assert_array_equal(ds.load_all()[0], pil.load_all()[0])
    rows = np.array([5, 1, 30])
    part = ds.take(rows)
    assert part.use_native is True
    np.testing.assert_array_equal(part.load_all()[0],
                                  ref.load_all()[0][rows])


def test_use_native_true_raises_where_unavailable(frames, monkeypatch):
    df, fdir, _ = frames
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: host library "
                                          "loader build failed: no jpeglib.h")
    assert native.build_error().endswith("no jpeglib.h")
    with pytest.raises(RuntimeError, match="unavailable.*no jpeglib.h"):
        FrameDataset(df, fdir, img_dim=(32, 32), use_native=True)
    assert FrameDataset(df, fdir, img_dim=(32, 32)).use_native is False
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.decode_jpeg_batch([], (32, 32))


@pytest.fixture()
def scratch_csrc(tmp_path, monkeypatch):
    """``_build`` pointed at a copy of ``csrc`` and an empty build dir, and
    ``native`` at a fresh, untried library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "NATIVE_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    return csrc / "loader.cc"


def test_stale_library_is_rebuilt_by_hash(libs, scratch_csrc, frames):
    _, _, paths = frames
    first = _build.build_host("loader")
    assert os.path.dirname(first) == _build.NATIVE_DIR
    assert os.path.basename(first).startswith("libablcloader-")
    mtime = os.stat(first).st_mtime_ns
    assert _build.build_host("loader") == first  # unchanged: not rebuilt
    assert os.stat(first).st_mtime_ns == mtime
    with open(scratch_csrc, "a") as f:
        f.write("\n// edited\n")
    second = _build.host_library_path("loader")
    assert second != first and not os.path.exists(second)
    assert native.native_available() and os.path.exists(second)
    np.testing.assert_array_equal(
        native.decode_jpeg_batch(paths[:2], (64, 64)),
        jax_native.decode_jpeg_batch(paths[:2], (64, 64)))


def test_build_error_gives_the_compiler_message(scratch_csrc):
    with open(scratch_csrc, "a") as f:
        f.write("\nthis is not C++;\n")
    assert not native.native_available()
    msg = native.build_error()
    assert "host library loader build failed" in msg and "error" in msg
    assert not os.listdir(_build.NATIVE_DIR) or not any(
        f.endswith(".so") for f in os.listdir(_build.NATIVE_DIR))
