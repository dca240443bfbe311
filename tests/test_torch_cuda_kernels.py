"""PyTorch port, CUDA kernels on the card: each kernel against its plain
PyTorch version. Every test here needs an NVIDIA GPU and nvcc, and skips
with a reason elsewhere (the kernels have no CPU mode). The module imports
only torch, numpy and the port, so it runs on a machine without JAX::

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda

Tolerance of the preprocess kernel: float32 within 1 ulp, bfloat16 within
1 bfloat16 ulp, taken at the larger of |out| and |bias[c]|
(``ops/image.py::max_ulp_error``). The port's kernel and plain version
agree exactly in practice.
"""

import itertools

import pytest
import torch

from ab_line_classifier_torch.ops import image as torch_image
from ab_line_classifier_torch.ops import preprocess_cuda
from ab_line_classifier_torch.ops.image import (MASK_OPTIONS, OUT_DTYPES,
                                                PREPROCESS_MODES, RESIZE_MODES,
                                                mask_kwargs, max_ulp_error)

OUT_HW = (32, 32)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, over the
    whole grid, with a 0/1 beam mask."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for hs, ws in ((70, 190), (480, 640), (601, 803)):
        x = torch.randint(0, 256, (3, hs, ws, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        m = (torch.rand((hs, ws), device="cuda", generator=gen)
             > 0.3).float()
        for mode, resize, mask, dtype in itertools.product(
                PREPROCESS_MODES, RESIZE_MODES, MASK_OPTIONS, OUT_DTYPES):
            kw = dict(out_hw=OUT_HW, preprocess_mode=mode,
                      resize_mode=resize, out_dtype=dtype,
                      **mask_kwargs(mask, m))
            before = preprocess_cuda.launch_count
            got = preprocess_cuda.cuda_preprocess(x, **kw)
            assert preprocess_cuda.launch_count == before + 1
            want = torch_image.fused_preprocess(x, **kw)
            max_ulp_error(got, want, dtype, mode)


@pytest.mark.cuda
def test_cuda_kernel_64bit_offsets():
    """A batch past 2^31 source bytes (1100 frames of 1080x1440x3): the
    last frames are read through 64-bit offsets."""
    _need_cuda()
    x = torch.randint(0, 256, (1100, 1080, 1440, 3), dtype=torch.uint8,
                      device="cuda")
    assert x.numel() > 2 ** 31
    kw = dict(out_hw=(128, 128), preprocess_mode="caffe", resize_mode="tf",
              out_dtype=torch.bfloat16)
    got = preprocess_cuda.cuda_preprocess(x, **kw)
    want = torch_image.fused_preprocess(x, **kw)
    max_ulp_error(got[-8:], want[-8:], torch.bfloat16, "caffe")
    assert torch.equal(got, want)
