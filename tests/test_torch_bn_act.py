"""PyTorch port, the batch norm pass's routing in ``graph.GraphModule``:
which batch norms normalize with their running statistics in one pass
(``ops/bn_act_cuda.py``), with which activation folded in, and where the
library chain (``F.batch_norm``, then the activation) is kept. On the CPU
the wrapper runs its plain version, the library chain itself, so these
tests exercise the routing the card takes and hold every output bit-equal
to the chain; the kernel is held to the chain, bit for bit and against the
chain in float32, by the card cases at the end (marked ``cuda``, skipped
without a card)::

    python -m pytest tests/test_torch_bn_act.py --noconftest -m cuda

Calls are counted by a spy in place of ``bn_act`` (the launch count counts
only launches on the card). The library chain is the same module with the
batch norm pass's entries taken out of its route table. The grad mode and
``vmap`` cases of both fused kernels' routes are in
``tests/test_torch_conv_epilogue.py``. The module imports only torch and
the port.
"""

import collections
import contextlib
import math

import pytest
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.ops import bn_act_cuda as BA
from ab_line_classifier_torch.ops import launches
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS, build_zoo

HW = (32, 32)


@pytest.fixture
def calls(monkeypatch):
    """Every ``bn_act`` call's ``(channels, act)``."""
    seen = []
    real = BA.bn_act

    def spy(x, mean, var, weight, bias, eps, act):
        seen.append((x.shape[1], act))
        return real(x, mean, var, weight, bias, eps, act)

    monkeypatch.setattr(BA, "bn_act", spy)
    return seen


@contextlib.contextmanager
def library_chain(module):
    """``module`` with every batch norm on the library chain."""
    kept = module._routes
    module._routes = {n: r for n, r in kept.items() if r.run is not G._bn_act}
    try:
        yield module
    finally:
        module._routes = kept


def _frames(n=2, seed=0, dtype=torch.float32, hw=HW):
    g = torch.Generator().manual_seed(seed)
    return (255 * torch.rand((n,) + hw + (3,), generator=g)).to(dtype)


def _stats(module, seed=1):
    """Running statistics and affine of every batch norm drawn from
    ``seed``, away from the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, G.BatchNorm):
                c = m.bias.shape[0]
                m.running_mean.copy_(torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(torch.randn(c, generator=g))
                if m.weight is not None:
                    m.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
    return module


@pytest.mark.parametrize("name,mixed,acts", [
    ("mobilenetv2", True, {"relu6": 26, "none": 13}),
    ("mobilenetv2", False, {"relu6": 26, "none": 13}),
    ("efficientnetb7", True, {"swish": 108, "none": 55}),
    ("xception", True, {"relu": 24, "none": 16}),
    ("custom_resnetv2", True, {"relu": 18}),
    ("cnn0", True, {"none": 4}),
    ("cutoffvgg16", True, {})])
def test_batch_norms_per_model(calls, name, mixed, acts):
    """Serving: every batch norm takes the pass (mobilenetv2 cut at
    block_12_add 39, 26 with its ReLU6; efficientnetb7 163, 108 with swish:
    the stem, 51 expand and 55 depthwise batch norms and the top; the
    project batch norms, read by an add or the next block, alone), and
    the outputs are bit-equal to the library chain's, in bfloat16 served
    cast whole and in float32."""
    spec = build_model(name, ZOO_HPARAMS[name], HW + (3,), 2,
                       mixed_precision=mixed)
    dtype = torch.bfloat16 if mixed else torch.float32
    module = spec.module().eval().to(dtype)
    x = _frames(dtype=dtype)
    G.adapt_batch_norm(module, x)
    calls.clear()
    with torch.no_grad():
        got = module(x)
        assert collections.Counter(a for _, a in calls) == acts
        with library_chain(module):
            want = module(x)
    assert len(calls) == sum(acts.values())
    assert torch.equal(got, want)


def test_folded_activations_are_the_graphs():
    """Each folded activation is its batch norm's only reader and is
    recognised from its spec (``F.relu``, ``F.silu``, ``op=("relu6",)``),
    never by the model's name."""
    spec = build_zoo("mobilenetv2", HW)
    module = spec.module()
    graph = spec.graph
    routes = {n: r for n, r in module._routes.items() if r.run is G._bn_act}
    for name, route in routes.items():
        assert graph[name].kind == G.KIND_BN
        if route.reader is not None:
            assert graph[route.reader].inputs == (name,)
            assert graph[route.reader].op == ("relu6",)
            assert route.args == ("relu6",)
    assert sum(r.reader is not None for r in routes.values()) == 26


def _small(capture=()):
    """conv -> bn (16) -> swish -> conv -> bn2 (12 channels: not whole
    16-byte vectors of bf16) -> ReLU -> conv -> bn3 (8, the output)."""
    graph = G.graph_of(
        G.conv2d("conv", G.INPUT, 3, 16, (3, 3), use_bias=False),
        G.batch_norm("bn", "conv", 16),
        G.activation("act", "bn", F.silu),
        G.conv2d("conv2", "act", 16, 12, (1, 1), use_bias=False),
        G.batch_norm("bn2", "conv2", 12),
        G.relu("relu2", "bn2"),
        G.conv2d("conv3", "relu2", 12, 8, (1, 1), use_bias=False),
        G.batch_norm("bn3", "conv3", 8, scale=False))
    module = G.GraphModule(graph, capture=capture,
                           generator=torch.Generator().manual_seed(0))
    return _stats(module).eval()


def _run(module, x, **kw):
    with torch.no_grad():
        return module(x, **kw)


@pytest.mark.parametrize("case,want", [
    ("serving", [(16, "swish"), (8, "none")]),
    ("frozen_in_training", [(16, "swish"), (8, "none")]),
    ("training", []),
    ("bn_stats", []),
    ("captured", [(16, "none"), (8, "none")]),
    ("leaf", [(16, "none"), (8, "none")]),
    ("overridden_bn", [(8, "none")]),
    ("overridden_act", [(16, "none"), (8, "none")]),
    ("float16", [])])
def test_routing_cases(calls, case, want):
    """Which batch norms of :func:`_small` take the pass, with which
    activation: bn2 (C % 8 != 0) never; the output's bn3 without an
    activation; bn's swish folded unless bn is captured or the ``leaf``,
    or the swish is overridden; an overridden batch norm runs nothing; a
    training batch norm (batch statistics) and the stacked form
    (``bn_stats``) keep the library chain, a frozen one in training takes
    the pass; a float16 input keeps the chain. Outputs, captures and
    statistics are the library chain's."""
    module = _small(("bn",) if case == "captured" else ())
    x = _frames(dtype=torch.float16 if case == "float16" else torch.float32)
    if case == "float16":
        module.to(torch.float16)
    kw = {}
    if case in ("training", "frozen_in_training", "bn_stats"):
        module.train()
        module.set_inference_bn(("bn", "bn2", "bn3")
                                if case == "frozen_in_training" else ())
    if case == "bn_stats":
        kw["bn_stats"] = {}
    if case == "leaf":
        kw["leaf"] = "bn"
    if case.startswith("overridden"):
        name = "bn" if case == "overridden_bn" else "act"
        _, caps = _run(_small((name,)), x)
        kw["overrides"] = {name: caps[name] + 1.0}
        calls.clear()
    state = {k: v.clone() for k, v in module.state_dict().items()}
    got = _run(module, x, **kw)
    assert calls == want
    after = {k: v.clone() for k, v in module.state_dict().items()}
    module.load_state_dict(state)
    with library_chain(module):
        ref = _run(module, x, **kw)
    assert calls == want
    for k, v in module.state_dict().items():
        assert torch.equal(after[k], v), k
    if isinstance(got, tuple):
        assert got[1].keys() == ref[1].keys()
        for k in got[1]:
            assert torch.equal(got[1][k], ref[1][k]), k
        got, ref = got[0], ref[0]
    assert torch.equal(got, ref)


def test_gradcam_tail_keeps_the_library_chain(calls):
    """Grad-CAM's tap of a 32x32 mobilenetv2 (``leaf`` at block_12_project,
    the module frozen, grad mode on): the 38 batch norms before the tap
    take the pass, the tap's recorded block_12_project_BN keeps the
    library chain; probabilities, tap and its gradient equal the chain's."""
    spec = build_zoo("mobilenetv2", HW)
    module = spec.module().eval().to(spec.dtype).requires_grad_(False)
    x = _frames(dtype=spec.dtype)
    G.adapt_batch_norm(module, x)
    calls.clear()
    outs = []
    for chain in (False, True):
        with library_chain(module) if chain else contextlib.nullcontext():
            probs, caps = module(x, leaf=spec.last_conv_layer)
            probs[:, 1].sum().backward()
            outs.append((probs.detach(), caps[spec.last_conv_layer].detach(),
                         caps[spec.last_conv_layer].grad))
    assert spec.last_conv_layer == "block_12_project"
    assert len(calls) == 38
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("act", BA.ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_library_chain(act, dtype):
    """The plain version is ``F.batch_norm`` with the running statistics
    and then the graph's activation, bit for bit, NaN and infinities
    included, with and without a weight."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 5, 7), generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    x[0, 0, 0, :3] = torch.tensor([float("nan"), float("inf"),
                                   float("-inf")]).to(dtype)
    mean, var, weight, bias = (torch.randn(16, generator=g),
                               0.5 + torch.rand(16, generator=g),
                               torch.randn(16, generator=g),
                               torch.randn(16, generator=g))
    fn = {"none": lambda y: y, "relu": F.relu,
          "relu6": lambda y: torch.clamp(y, 0.0, 6.0), "swish": F.silu}[act]
    for w in (weight, None):
        want = fn(F.batch_norm(x, mean, var, w, bias, False, 0.0, 1e-3))
        got = BA.bn_act(x, mean, var, w, bias, 1e-3, act)
        assert got.dtype == dtype
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("units,c,itemsize,fit,grid", [
    (2 ** 28, 64, 2, 8, 132 * 8),
    (2 ** 28, 96, 2, 7, 924),        # cvecs 12: grid a multiple of 3
    (2 ** 28, 3840, 2, 6, 780),      # cvecs 480: of 15
    (2 ** 28, 3840, 4, 6, 780),      # cvecs 960: of 15
    (1000, 48, 4, 6, 3),
    (5, 64, 4, 8, 1)])
def test_launch_grid(units, c, itemsize, fit, grid):
    """Blocks of 256; the grid's stride a multiple of a pixel's vectors (so
    each thread keeps its channels, and their scale and shift, at every
    step), as many blocks as fit on the card at once or as the work
    needs."""
    cvecs = c * itemsize // 16
    got = BA.launch_grid(units, cvecs, 132, fit)
    assert got == grid
    assert got * BA.THREADS % cvecs == 0
    assert got <= 132 * fit or got == cvecs // math.gcd(256, cvecs)
    with pytest.raises(ValueError):
        BA.launch_grid(units, 0, 132, fit)


# --- On the card -----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _card_case(shape, dtype, gen, weight=True):
    """A channels_last ``[B, C, H, W]`` input and float32 statistics and
    affine on the card, ``x`` around the mean by a few deviations."""
    b, c, h, w = shape
    mean = torch.randn(c, device="cuda", generator=gen)
    var = 0.05 + 2 * torch.rand(c, device="cuda", generator=gen)
    x = (mean + 3 * var.sqrt() * torch.randn(
        (b, h, w, c), device="cuda", generator=gen)).to(dtype)
    wt = (0.5 + torch.rand(c, device="cuda", generator=gen)) if weight \
        else None
    bias = torch.randn(c, device="cuda", generator=gen)
    return x.permute(0, 3, 1, 2), mean, var, wt, bias


def _chain32(x, mean, var, weight, bias, eps, act):
    """The chain in float32: ``(act(y), |terms|)``, the terms' size being
    the scale the float32 rounding errors are taken at."""
    shape = (1, -1, 1, 1)
    s = torch.rsqrt(var + eps)
    if weight is not None:
        s = s * weight
    t = (x.float() - mean.view(shape)) * s.view(shape)
    y = t + bias.view(shape)
    fn = {"none": lambda v: v, "relu": F.relu,
          "relu6": lambda v: torch.clamp(v, 0.0, 6.0), "swish": F.silu}[act]
    return fn(y), t.abs() + bias.abs().view(shape)


def _bf16_ulp(v):
    """One bfloat16 ulp at ``|v|`` (float32; the smallest normal's below)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
def test_kernel_within_an_ulp_of_the_float32_chain():
    """Every activation, bf16 and float32, with and without a weight, at
    channel counts of 1 to 480 vectors and odd sizes: bfloat16 within one
    bf16 ulp of the float32 chain rounded once, float32 within 2e-6 of it
    relative to the terms' size; one counted launch a call. bf16 swish
    reads the batch norm's output rounded to bf16, as ``F.silu`` reads
    ``F.batch_norm``'s (swish does not commute with that rounding): it is
    held to ``F.silu`` of the pass without an activation, which is held
    to the float32 chain here."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(23)
    for dtype, c, act, weight, (b, h, w) in (
            (dt, c, a, wt, s) for dt in (torch.bfloat16, torch.float32)
            for c in (8, 24, 96, 144, 576, 3840) for a in BA.ACTS
            for wt in (True, False)
            for s in ((2, 7, 9), (3, 19, 19))):
        x, mean, var, wt, bias = _card_case((b, c, h, w), dtype, gen, weight)
        before = launches.count("bn_act")
        got = BA.bn_act(x, mean, var, wt, bias, 1e-3, act)
        assert launches.count("bn_act") == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        assert got.is_contiguous(memory_format=torch.channels_last)
        if dtype == torch.bfloat16 and act == "swish":
            assert torch.equal(got, F.silu(BA.bn_act(x, mean, var, wt, bias,
                                                     1e-3, "none")))
            continue
        want, terms = _chain32(x, mean, var, wt, bias, 1e-3, act)
        err = (got.float() - want.to(dtype).float()).abs()
        if dtype == torch.bfloat16:
            tol = _bf16_ulp(want) + 2e-6 * terms
        else:
            tol = 2e-6 * (terms + want.abs())
        assert bool((err <= tol).all()), (dtype, c, act, weight,
                                          float((err / tol).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_is_bit_equal_to_the_library_chain(dtype):
    """Every activation, with and without a weight, at channel counts of 1
    to 480 vectors: the pass equals ``F.batch_norm`` and then the
    activation bit for bit, NaN and infinities included. In float32 the
    chain runs ATen's own batch norm (cuDNN off: with a weight, cuDNN's
    batch norm would take the chain there, in its own order)."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(27)
    special = torch.tensor([float("nan"), float("inf"), float("-inf")],
                           device="cuda")
    for c, act, weight in ((c, a, wt) for c in (8, 24, 144, 3840)
                           for a in BA.ACTS for wt in (True, False)):
        x, mean, var, wt, bias = _card_case((3, c, 11, 13), dtype, gen,
                                            weight)
        x[0, :3, 0, 0] = special.to(dtype)
        got = BA.bn_act(x, mean, var, wt, bias, 1e-3, act)
        with torch.backends.cudnn.flags(enabled=False):
            want = BA.bn_act_plain(x, mean, var, wt, bias, 1e-3, act)
        assert torch.equal(got.isnan(), want.isnan()), (c, act, weight)
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), (
            c, act, weight, float((got - want).abs().nan_to_num().max()))


@pytest.mark.cuda
def test_kernel_passes_nan_and_infinities_as_the_chain():
    """NaN and +-inf in the input come out as the float32 chain's: NaN
    stays NaN (ReLU and ReLU6 included), ReLU6 clamps +inf to 6 and -inf
    to 0, swish of -inf is NaN as ATen's SiLU gives it."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(24)
    special = torch.tensor([float("nan"), float("inf"), float("-inf")],
                           device="cuda")
    for dtype, act in ((d, a) for d in (torch.bfloat16, torch.float32)
                       for a in BA.ACTS):
        x, mean, var, wt, bias = _card_case((2, 16, 3, 3), dtype, gen)
        x[0, :3, 0, 0] = special.to(dtype)
        x[1, 5, 2, :3] = special.to(dtype)
        got = BA.bn_act(x, mean, var, wt, bias, 1e-3, act).float()
        want = _chain32(x, mean, var, wt, bias, 1e-3, act)[0].to(
            dtype).float()
        assert torch.equal(got.isnan(), want.isnan()), (dtype, act)
        inf = want.isinf()
        assert torch.equal(got.isinf(), inf), (dtype, act)
        assert torch.equal(got[inf], want[inf]), (dtype, act)


@pytest.mark.cuda
def test_kernel_one_launch_past_2_31_elements():
    """One launch over 2.16 G bf16 elements (1000 x 96 x 150 x 150):
    bit-equal to the library chain; the batch norm's last frames, reached
    through 64-bit offsets, within an ulp of the float32 chain."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(25)
    c = 96
    mean = torch.randn(c, device="cuda", generator=gen)
    var = 0.5 + torch.rand(c, device="cuda", generator=gen)
    weight = torch.randn(c, device="cuda", generator=gen)
    bias = torch.randn(c, device="cuda", generator=gen)
    x = torch.randn((1000, 150, 150, c), device="cuda", dtype=torch.bfloat16,
                    generator=gen).permute(0, 3, 1, 2)
    assert x.numel() > 2 ** 31
    before = launches.count("bn_act")
    got = BA.bn_act(x, mean, var, weight, bias, 1e-3, "swish")
    assert launches.count("bn_act") == before + 1
    assert torch.equal(got, BA.bn_act_plain(x, mean, var, weight, bias, 1e-3,
                                            "swish"))
    del got
    got = BA.bn_act(x, mean, var, weight, bias, 1e-3, "none")
    for part in (slice(0, 2), slice(-3, None)):
        want = _chain32(x[part], mean, var, weight, bias, 1e-3, "none")[0]
        err = (got[part].float() - want.to(torch.bfloat16).float()).abs()
        assert bool((err <= _bf16_ulp(want) + 1e-5).all())


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take():
    """No fallback on the card: channels that are not whole 16-byte
    vectors, NCHW memory, statistics of another dtype or shape, float16,
    an unknown activation."""
    _need_cuda()
    x, mean, var, wt, bias = _card_case((2, 16, 4, 4), torch.bfloat16,
                                        torch.Generator(device="cuda"))
    nchw = x.contiguous()
    cases = [((x[:, :12], mean[:12], var[:12], wt[:12], bias[:12]), "relu",
              ValueError),
             ((nchw, mean, var, wt, bias), "relu", ValueError),
             ((x, mean.double(), var, wt, bias), "relu", ValueError),
             ((x, mean, var[:8], wt, bias), "relu", ValueError),
             ((x.half(), mean, var, wt, bias), "relu", ValueError),
             ((x, mean, var, wt, bias), "gelu", ValueError)]
    for args, act, err in cases:
        with pytest.raises(err):
            BA.bn_act(*args, 1e-3, act)


@pytest.mark.cuda
@pytest.mark.parametrize("name,per_forward", [("mobilenetv2", 39),
                                              ("efficientnetb7", 163)])
def test_graphed_serving_counts_the_pass(name, per_forward):
    """A graphed serving forward (``Predictor``, bf16, cuDNN
    deterministic) at 32x32: its capture holds ``per_forward`` launches of
    the pass (mobilenetv2 cut at block_12_add, efficientnetb7), counted
    again at each replay, as many as the eager forward makes; the replays
    bit-equal to the eager forward."""
    _need_cuda()
    from ab_line_classifier_torch.ops.preprocess_cuda import (
        preprocess_frames)
    from ab_line_classifier_torch.predict.benchmark import seeded_state
    from ab_line_classifier_torch.predict.predict import Predictor

    flags = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        spec = build_zoo(name, HW)
        predictor = Predictor(spec, seeded_state(spec, 3), batch_size=8,
                              device="cuda")
        assert predictor.graph_mode == "graphed"
        frames = torch.randint(0, 256, (8,) + HW + (3,), dtype=torch.uint8,
                               device="cuda")
        G.adapt_batch_norm(predictor.module, preprocess_frames(
            frames, out_hw=HW, preprocess_mode=spec.preprocess_mode,
            out_dtype=spec.dtype))
        for _ in range(3):
            probs = predictor.forward(frames)
        summary, = predictor.summaries().values()
        assert summary["captured_launches"]["bn_act"] == per_forward
        before = launches.count("bn_act")
        predictor.forward(frames)
        assert launches.count("bn_act") == before + per_forward
        want = predictor.eager(frames)
        assert launches.count("bn_act") == before + 2 * per_forward
        assert torch.equal(probs, want)
    finally:
        torch.backends.cudnn.deterministic = flags
