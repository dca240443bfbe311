"""PyTorch port, preprocessing: the port's plain ``fused_preprocess``
against the JAX package's, over every mode x resize map x mask option x
output dtype; the port against the Pallas kernel in interpret mode; the
index maps. The CUDA kernel's test is tests/test_torch_cuda_kernels.py.

Tolerances: float32 outputs within 1 ulp, bfloat16 outputs within 1
bfloat16 ulp, at the larger of |out| and |bias| (``ops/image.py::
max_ulp_error``; XLA may contract the affine into one FMA). Against the
Pallas kernel, the atol its own test uses (2e-3, tests/test_preprocess.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.ops import image as jax_image
from ab_line_classifier_tpu.ops.preprocess_pallas import pallas_preprocess
from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.ops import launches, preprocess_cuda
from ab_line_classifier_torch.ops.image import (MASK_OPTIONS, OUT_DTYPES,
                                                PREPROCESS_MODES, RESIZE_MODES,
                                                mask_kwargs, max_ulp_error)

OUT_HW = (32, 32)
DTYPES = [str(d).removeprefix("torch.") for d in OUT_DTYPES]


@pytest.fixture(scope="module")
def frames():
    # 70x190 so the 50x160 UI box blanks part of the frame, not all of it.
    return np.random.RandomState(0).randint(
        0, 256, (2, 70, 190, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def beam(frames):
    return (np.random.RandomState(1).rand(*frames.shape[1:3])
            > 0.3).astype(np.float32)


def _kwargs(mode, resize, mask, beam):
    return dict(out_hw=OUT_HW, preprocess_mode=mode, resize_mode=resize,
                **mask_kwargs(mask, beam))


@pytest.mark.parametrize(
    "mode,resize,mask,dtype",
    list(itertools.product(PREPROCESS_MODES, RESIZE_MODES, MASK_OPTIONS,
                           DTYPES)))
def test_fused_preprocess_matches_jax(frames, beam, mode, resize, mask,
                                      dtype):
    kw = _kwargs(mode, resize, mask, beam)
    jax_kw = dict(kw, out_dtype=getattr(jnp, dtype),
                  mask=None if kw["mask"] is None else jnp.asarray(beam))
    want = np.asarray(jax_image.fused_preprocess(jnp.asarray(frames),
                                                 **jax_kw)).astype(np.float32)
    got = torch_image.fused_preprocess(torch.from_numpy(frames), **kw,
                                       out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    max_ulp_error(got, want, got.dtype, mode)


@pytest.mark.parametrize("mode", PREPROCESS_MODES)
def test_port_matches_pallas_interpret(frames, beam, mode):
    want = np.asarray(pallas_preprocess(
        jnp.asarray(frames), out_hw=OUT_HW, preprocess_mode=mode,
        resize_mode="tf", mask=beam, interpret=True))
    got = torch_image.fused_preprocess(
        torch.from_numpy(frames), out_hw=OUT_HW, preprocess_mode=mode,
        resize_mode="tf", mask=beam).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("resize", RESIZE_MODES)
def test_nearest_indices_equal(resize):
    rng = np.random.RandomState(5)
    sizes = [(1, 1), (4, 2), (2, 4), (480, 128), (640, 128), (1080, 128),
             (1440, 128), (601, 128), (803, 128), (128, 128), (7, 300)]
    sizes += [tuple(rng.randint(1, 2000, 2)) for _ in range(300)]
    for src, dst in sizes:
        np.testing.assert_array_equal(
            torch_image.nearest_indices(int(src), int(dst), resize),
            jax_image.nearest_indices(int(src), int(dst), resize),
            err_msg=f"{resize} {src}->{dst}")


def test_preprocess_frames_runs_plain_version_on_cpu(frames, beam):
    """A CPU tensor takes the plain version and launches nothing; a CPU
    tensor handed to the kernel wrapper itself raises."""
    x = torch.from_numpy(frames)
    kw = _kwargs("caffe", "tf", "beam", beam)
    before = launches.count("preprocess")
    got = preprocess_cuda.preprocess_frames(x, **kw)
    assert launches.count("preprocess") == before
    torch.testing.assert_close(got, torch_image.fused_preprocess(x, **kw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        preprocess_cuda.cuda_preprocess(x, **kw)


def test_single_frame_keeps_rank(frames):
    out = preprocess_cuda.preprocess_frames(torch.from_numpy(frames[0]),
                                            out_hw=OUT_HW)
    assert tuple(out.shape) == OUT_HW + (3,)
