"""PyTorch port, the one launch path of its hand-written kernels
(``ops/_build.py::Kernel``) and the input check the fused kernels share
(``ops/_build.py::check_nhwc``), on the CPU: a stand-in library object
takes the place of a built kernel, and ``torch.cuda``'s stream and device
queries are stood in for, so nothing here needs a card. The kernels
themselves are held on the card by ``tests/test_torch_cuda_kernels.py``.
"""

import contextlib
import types

import pytest
import torch

from ab_line_classifier_torch.ops import _build, launches

CUDA0 = torch.device("cuda", 0)


class _Library:
    """A stand-in kernel library: ``ablc_run`` returns ``rc`` and records
    its arguments, ``ablc_fit`` counts the blocks an SM holds."""

    def __init__(self, rc=0, fit=3):
        self.rc, self.fit, self.calls, self.queries = rc, fit, [], []

    def ablc_run(self, *args):
        self.calls.append(args)
        return self.rc

    def ablc_fit(self, *args):
        self.queries.append(args)
        return self.fit

    @staticmethod
    def ablc_error_string(rc):
        return f"error {rc}: invalid configuration argument".encode()


@pytest.fixture
def on_card(monkeypatch):
    """``torch.cuda``'s current stream, device and properties stood in
    for: stream 1234 on device 0 of 132 SMs."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=1234))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=132))


@pytest.mark.parametrize("key", launches.KERNELS)
def test_a_failed_launch_raises_its_error_string_and_counts_nothing(
        on_card, key):
    """A non-zero return raises ``RuntimeError`` with the kernel's own
    decoded error string, and its count does not move; a launch that
    succeeds gets the stream as its last argument and counts one, under
    its kernel's key only, unless asked not to count."""
    kernel = _build.Kernel("stand_in", key)
    kernel.lib = _Library(rc=9)
    before = launches.counts()
    with pytest.raises(RuntimeError, match="stand_in kernel launch failed: "
                       "error 9: invalid configuration argument"):
        kernel.launch("ablc_run", CUDA0, 1, 2)
    assert launches.counts() == before
    kernel.lib.rc = 0
    kernel.launch("ablc_run", CUDA0, 3, 4)
    kernel.launch("ablc_run", CUDA0, 5, 6, count=False)
    assert kernel.lib.calls == [(1, 2, 1234), (3, 4, 1234), (5, 6, 1234)]
    want = dict(before)
    want[key] += 1
    assert launches.counts() == want


def test_occupancy_is_asked_once_per_variant(on_card):
    """``(SMs, blocks an SM holds)``, asked of the library once per device
    and variant; a variant of which no block fits raises."""
    kernel = _build.Kernel("stand_in", "bn_act")
    kernel.lib = _Library(fit=6)
    assert kernel.occupancy("ablc_fit", CUDA0, 1, 3) == (132, 6)
    assert kernel.occupancy("ablc_fit", CUDA0, 1, 3) == (132, 6)
    assert kernel.occupancy("ablc_fit", CUDA0, 0, 3) == (132, 6)
    assert kernel.lib.queries == [(1, 3), (0, 3)]
    kernel.lib.fit = 0
    with pytest.raises(RuntimeError, match="fits on an SM"):
        kernel.occupancy("ablc_fit", CUDA0, 0, 2)


def _nhwc(c, dtype=torch.bfloat16):
    return torch.zeros((2, 3, 5, c), dtype=dtype).permute(0, 3, 1, 2)


def test_check_nhwc_takes_what_the_fused_kernels_take():
    """NHWC memory of whole 16-byte vectors of float32 or bfloat16
    channels, 16-byte aligned, passes; anything else raises."""
    for x in (_nhwc(8), _nhwc(16), _nhwc(4, torch.float32)):
        _build.check_nhwc(x, "x")
    for x, match in ((_nhwc(12), "whole 16-byte vectors"),
                     (_nhwc(6, torch.float32), "whole 16-byte vectors"),
                     (_nhwc(8, torch.float16), "float32 or bfloat16"),
                     (_nhwc(8)[0], "float32 or bfloat16"),
                     (_nhwc(8).contiguous(), "channels_last"),
                     (torch.zeros(2 * 3 * 5 * 8 + 1, dtype=torch.bfloat16)[
                         1:].view(2, 3, 5, 8).permute(0, 3, 1, 2),
                      "16-byte aligned")):
        with pytest.raises(ValueError, match=match):
            _build.check_nhwc(x, "x")


def test_the_route_tables_channel_rule_is_whole_vectors_in_each_dtype():
    """A channel count is a multiple of ``VECTOR_CHANNELS`` (the route
    table's rule, fixed before any dtype is known) exactly where it is
    whole 16-byte vectors in every dtype the fused kernels take."""
    sizes = [torch.empty(0, dtype=d).element_size() for d in _build.DTYPES]
    for c in range(1, 65):
        assert (c % _build.VECTOR_CHANNELS == 0) == all(
            c * size % 16 == 0 for size in sizes), c
