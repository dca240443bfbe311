"""PyTorch port, the conv epilogue's routing in ``graph.GraphModule``: which
convs add their bias, take their ReLU and their 2x2 max-pool in one pass
(``ops/conv_epilogue_cuda.py``), and that every output and gradient is
bit-equal to the library chain it replaces (the bias inside the conv, the
activation, the pool). On the CPU the wrapper runs its plain version, so
these tests exercise the routing the card takes; the kernel itself is
held to the plain version in ``tests/test_torch_cuda_kernels.py``.

Calls are counted by a spy in place of ``conv_epilogue`` (the launch count
counts only launches on the card). The library chain is the same module
with the conv epilogue's entries taken out of its route table. The grad
mode and ``vmap`` cases hold both fused kernels' routes, this one's and
the batch norm pass's (``tests/test_torch_bn_act.py``).
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import make_optimizer
from ab_line_classifier_torch.ops import bn_act_cuda as BA
from ab_line_classifier_torch.ops import conv_epilogue_cuda as CE
from ab_line_classifier_torch.predict.benchmark import ZOO_HPARAMS
from test_torch_bn_act import _frames as _bn_frames, _small, _stats

HW = (32, 32)

#: Each fused kernel's wrapper, what a spy records of a call
#: (``(channels, pool)`` of the conv epilogue, ``(channels, act)`` of the
#: batch norm pass), and the route table's call of it.
WRAPPERS = {
    "epilogue": (CE, "conv_epilogue",
                 lambda y, bias, relu, pool: (y.shape[1], pool),
                 G._conv_epilogue),
    "bn_act": (BA, "bn_act",
               lambda x, mean, var, weight, bias, eps, act: (x.shape[1],
                                                              act),
               G._bn_act)}


def spy(monkeypatch, kernel):
    """Every call of ``kernel``'s wrapper from now on (:data:`WRAPPERS`)."""
    mod, name, record, _ = WRAPPERS[kernel]
    seen = []
    real = getattr(mod, name)

    def wrapper(*args):
        seen.append(record(*args))
        return real(*args)

    monkeypatch.setattr(mod, name, wrapper)
    return seen


@pytest.fixture
def calls(monkeypatch):
    """Every ``conv_epilogue`` call's ``(channels, pool)``."""
    return spy(monkeypatch, "epilogue")


@contextlib.contextmanager
def library_chain(module, kernel="epilogue"):
    """``module`` with every layer that runs through ``kernel`` on the
    library chain."""
    kept, run = module._routes, WRAPPERS[kernel][3]
    module._routes = {n: r for n, r in kept.items() if r.run is not run}
    try:
        yield module
    finally:
        module._routes = kept


def _spec(name, mixed=False):
    return build_model(name, ZOO_HPARAMS.get(name, {}), HW + (3,), 2,
                       mixed_precision=mixed)


def _frames(n=3, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (20 * torch.randn((n,) + HW + (3,), generator=g)).to(dtype)


@pytest.mark.parametrize("name,mixed,n,pooled", [
    ("vgg16", False, 13, 5), ("cutoffvgg16", False, 7, 2),
    ("cutoffvgg16", True, 7, 2), ("cnn0", False, 4, 0),
    ("custom_resnetv2", False, 22, 0), ("mobilenetv2", False, 0, 0)])
def test_epilogues_per_model(calls, name, mixed, n, pooled):
    """The convs with a bias and a ReLU or no activation take the epilogue,
    and the 2x2 VALID pools that read only them are pooled inside it (not
    cnn0's SAME pools after a batch norm); serving outputs bit-equal to the
    library chain's, in float32 and, served cast whole, in bfloat16."""
    spec = _spec(name, mixed)
    dtype = torch.bfloat16 if mixed else torch.float32
    module = spec.module().eval().to(dtype)
    x = _frames(dtype=dtype)
    with torch.no_grad():
        got = module(x)
        assert len(calls) == n
        assert sum(p for _, p in calls) == pooled
        with library_chain(module):
            want = module(x)
    assert len(calls) == n
    assert torch.equal(got, want)


def _cut_vgg(capture=()):
    """cutoffvgg16's backbone and head at 32x32 in float32, its activations
    of ``capture`` returned."""
    spec = _spec("cutoffvgg16")
    module = G.GraphModule(spec.graph, capture=capture)
    module.load_state_dict(spec.module().state_dict())
    return module.eval()


@pytest.mark.parametrize("kw,pooled", [
    ({}, {"block1_conv2", "block2_conv2"}),
    ({"capture": ("block1_conv2",)}, {"block2_conv2"}),
    ({"capture": ("block1_pool",)}, {"block1_conv2", "block2_conv2"}),
    ({"leaf": "block2_conv2"}, {"block1_conv2"}),
    ({"leaf": "block1_pool"}, {"block2_conv2"}),
    ({"overrides": "block1_pool"}, {"block2_conv2"}),
    ({"overrides": "block2_conv2"}, {"block1_conv2"})])
def test_pool_fusion_where_nothing_needs_the_conv_alone(calls, kw, pooled):
    """A conv's pool is not fused when the conv is captured (decided at
    construction), is the ``leaf`` or overridden, or its pool is the leaf or
    overridden (decided per call); an overridden conv runs nothing. The
    outputs and the activations returned are the library chain's."""
    module = _cut_vgg(kw.get("capture", ()))
    x = _frames()
    args = {}
    if "leaf" in kw:
        args["leaf"] = kw["leaf"]
    if "overrides" in kw:
        with torch.no_grad():
            _, caps = _cut_vgg((kw["overrides"],))(x)
        args["overrides"] = {kw["overrides"]: caps[kw["overrides"]] + 1.0}
        calls.clear()
    names = {n: c for n, c in (("block1_conv2", 64), ("block2_conv2", 128))}
    with torch.no_grad():
        got = module(x, **args)
        with library_chain(module):
            want = module(x, **args)
    assert {n for n, c in names.items() if (c, True) in calls} == pooled
    assert sum(p for _, p in calls) == len(pooled)
    if isinstance(got, tuple):
        assert got[1].keys() == want[1].keys()
        for k in got[1]:
            assert torch.equal(got[1][k], want[1][k]), k
        got, want = got[0], want[0]
    assert torch.equal(got, want)


def test_forward_hooks_see_the_conv_output(calls):
    """The conv stays a call of its module: a forward hook on a pooled
    conv sees the conv's own output shape, not the pool's."""
    module = _cut_vgg()
    shapes = []
    module.block1_conv2.register_forward_hook(
        lambda m, args, out: shapes.append(tuple(out.shape)))
    with torch.no_grad():
        module(_frames(n=2))
    assert shapes == [(2, 64) + HW]
    assert (64, True) in calls


def _finetune_step(module, phase, x, labels):
    module.train()
    opt = make_optimizer(phase, module)
    probs = module(x, generator=torch.Generator().manual_seed(1))
    loss = F.nll_loss(torch.log(probs), labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()
             if p.grad is not None}
    opt.step()
    return loss.detach(), grads, {n: p.detach().clone()
                                  for n, p in module.named_parameters()}


@pytest.mark.parametrize("compute", [None, torch.bfloat16])
def test_finetune_step_takes_the_frozen_prefix(calls, compute):
    """A ``finetune`` step: the five frozen convs (their weights not
    requiring grad, the input neither) take the epilogue under grad mode,
    with both pools; the trained block3_conv2/3 keep the library chain.
    Loss, gradients and updated parameters bit-equal to the library
    chain's, float32 and with bfloat16 compute."""
    spec = _spec("cutoffvgg16")
    phase = {p.name: p for p in spec.phases}["finetune"]
    state = spec.module().state_dict()
    x, labels = _frames(n=4), torch.tensor([0, 1, 1, 0])
    runs = []
    for chain in (False, True):
        module = spec.module()
        module.load_state_dict(state)
        G.set_compute_dtype(module, compute)
        with library_chain(module) if chain else contextlib.nullcontext():
            runs.append(_finetune_step(module, phase, x, labels))
        if not chain:
            assert [c for c, _ in calls] == [64, 64, 128, 128, 256]
            assert sum(p for _, p in calls) == 2
    (loss, grads, params), (loss0, grads0, params0) = runs
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys() and grads
    assert all(n.startswith(("block3_conv2", "block3_conv3", "logits"))
               for n in grads)
    for n in grads:
        assert torch.equal(grads[n], grads0[n]), n
    for n in params:
        assert torch.equal(params[n], params0[n]), n


#: Per kernel: a model and an input; the layers whose freezing lets the
#: first of its routes take the kernel, and the calls that then make; the
#: calls of a forward with every layer taking it.
GRAD_CASES = {
    "epilogue": (lambda: (_cut_vgg(), _frames()),
                 ("block1_conv1", "block1_conv2"),
                 [(64, False), (64, True)],
                 [(64, False), (64, True), (128, False), (128, True),
                  (256, False), (256, False), (256, False)]),
    "bn_act": (lambda: (_small(), _bn_frames()), ("conv", "bn"),
               [(16, "swish")], [(16, "swish"), (8, "none")])}


@pytest.mark.parametrize("kernel", ["epilogue", "bn_act"])
def test_grad_mode_keeps_the_library_chain_where_autograd_records(
        monkeypatch, kernel):
    """Under grad mode a layer whose weight or bias requires grad, or whose
    input does, keeps the library chain (so would every layer after it);
    with nothing requiring grad every layer takes its kernel, and under
    ``no_grad`` every layer takes it whatever requires grad: each fused
    kernel's route."""
    build, prefix, first, every = GRAD_CASES[kernel]
    calls = spy(monkeypatch, kernel)
    module, x = build()
    module(x)
    assert calls == []
    for name in prefix:
        module.get_submodule(name).requires_grad_(False)
    module(x)
    assert calls == first
    calls.clear()
    module.requires_grad_(False)
    module(x.clone().requires_grad_())
    assert calls == []
    module(x)
    assert calls == every
    calls.clear()
    with torch.no_grad():
        module(x.clone().requires_grad_())
        build()[0](x.clone().requires_grad_())
    assert calls == every * 2


def test_gradcam_leaf_keeps_the_in_place_epilogue(calls):
    """Grad-CAM's tap (``leaf`` at block3_conv3, the module frozen, grad
    mode on): every conv takes the epilogue, the tap's in place, and the
    heatmap's gradient is the library chain's."""
    module = _cut_vgg().requires_grad_(False)
    x = _frames()
    outs = []
    for chain in (False, True):
        with library_chain(module) if chain else contextlib.nullcontext():
            probs, caps = module(x, leaf="block3_conv3")
            probs[:, 1].sum().backward()
            outs.append((probs.detach(), caps["block3_conv3"].detach(),
                         caps["block3_conv3"].grad))
    assert len(calls) == 7 and sum(p for _, p in calls) == 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _vmap_convs():
    """Three conv -> pool modules of their own weights, and an input."""
    graph = G.graph_of(
        G.conv2d("conv", G.INPUT, 3, 8, (3, 3), act=F.relu),
        G.max_pool("pool", "conv", (2, 2)))
    return [G.GraphModule(graph, generator=torch.Generator().manual_seed(s))
            for s in range(3)], _frames(n=2)


def _vmap_bns():
    """Three small batch norm models of their own statistics, an input."""
    return [_stats(_small(), seed=s) for s in range(3)], _bn_frames()


#: Per kernel: the modules and input, the kernel's calls a module's
#: forward makes, and how close a trial's output under ``vmap`` is to its
#: own module's (the batch norms to vmap's batch-norm rule's rounding).
VMAP_CASES = {
    "epilogue": (_vmap_convs, 1, dict(rtol=0, atol=0)),
    "bn_act": (_vmap_bns, 2, dict(rtol=1e-5, atol=1e-4))}


@pytest.mark.parametrize("kernel", ["epilogue", "bn_act"])
def test_vmap_keeps_the_library_chain(monkeypatch, kernel):
    """Under ``torch.func.vmap`` over stacked parameters and statistics
    (the stacked trials) every layer keeps the library chain: the output
    is the chain's bit for bit, and each trial's is its own module's; each
    fused kernel's route."""
    build, per_forward, tol = VMAP_CASES[kernel]
    mods, x = build()
    calls = spy(monkeypatch, kernel)
    stacked = {k: torch.stack([m.state_dict()[k] for m in mods])
               for k in mods[0].state_dict()}

    def run():
        return torch.func.vmap(
            lambda p: torch.func.functional_call(mods[0], p, (x,)))(stacked)

    got = run()
    assert calls == []
    with library_chain(mods[0], kernel):
        assert torch.equal(got, run())
    with torch.no_grad():
        for i, m in enumerate(mods):
            torch.testing.assert_close(got[i], m(x), **tol)
    assert len(calls) == len(mods) * per_forward


def test_plain_version_is_the_library_chain():
    """The plain version is the bias add, ReLU and pool as the port ran
    them, NaN, infinities and odd sizes included: in place without the
    pool, ``y`` left as it was with it."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn((2, 16, 7, 9), generator=g).contiguous(
        memory_format=torch.channels_last)
    y[0, 0, 0, 0], y[0, 1, 2, 3], y[1, 2, 4, 4] = (float("nan"),
                                                   float("inf"),
                                                   float("-inf"))
    bias = torch.randn(16, generator=g)
    for relu, pool in ((True, True), (True, False), (False, True),
                       (False, False)):
        want = y + bias.view(1, -1, 1, 1)
        want = F.relu(want) if relu else want
        want = F.max_pool2d(want, 2, 2) if pool else want
        before = y.clone()
        got = CE.conv_epilogue(y, bias, relu, pool)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
        if pool:
            assert got.shape == (2, 16, 3, 4)
            assert torch.equal(y.nan_to_num(), before.nan_to_num())
        else:
            assert got.data_ptr() == y.data_ptr()
            y = before


@pytest.mark.parametrize("units,c,itemsize,fit,per_thread,threads,grid", [
    (2 ** 28, 64, 2, 8, 4, 256, 132 * 8),
    (2 ** 28, 96, 2, 8, 4, 252, 132 * 8),
    (1000, 48, 4, 6, 1, 252, 4),
    (5, 64, 4, 8, 4, 256, 1)])
def test_launch_geometry(units, c, itemsize, fit, per_thread, threads, grid):
    """Blocks are a multiple of a pixel's vectors (each thread keeps its
    channels, and its bias, at every step of the grid's stride), as many as
    fit on the card at once or as the work needs."""
    cvecs = c * itemsize // 16
    assert CE.launch_geometry(units, cvecs, 132, fit, per_thread) == (
        threads, grid)
    assert threads % cvecs == 0
    assert grid == 132 * fit or grid * threads * per_thread >= units
    with pytest.raises(ValueError):
        CE.launch_geometry(units, 300, 132, fit)
