"""PyTorch port, per-stage attribution (``predict/attribution.py``) against
the JAX package's.

The stage boundaries equal the JAX package's for all seven zoo models; a
non-dominating explicit boundary raises. The load-bearing claim is that a
segment is exactly its stage's serving computation and nothing before it:
chaining the segments reproduces the full float32 forward bit for bit on
the CPU, their FLOPs sum to the full model's, and a forward hook on every
parameterized layer shows that no segment runs a layer at or before its
previous boundary (eager PyTorch removes no dead code, so a segment built
as the JAX package builds it would run the whole prefix).
"""

import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.models import build_model as jax_build_model
from ab_line_classifier_tpu.predict.attribution import (
    auto_boundaries as jax_auto_boundaries)
from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.efficientnet import build_efficientnet
from ab_line_classifier_torch.predict.attribution import (
    attribute_stages, auto_boundaries, segment_module, serving_boundaries,
    stage_segments)
from ab_line_classifier_torch.predict.benchmark import (ZOO_HPARAMS,
                                                        flops_per_frame)
from ab_line_classifier_torch.predict.predict import load_module

SHAPE = (32, 32, 3)
ZOO = ("cutoffvgg16", "vgg16", "mobilenetv2", "xception", "efficientnetb7",
       "custom_resnetv2", "cnn0")
CHAINED = ("cnn0", "mobilenetv2", "xception", "custom_resnetv2")
JAX_ROW_KEYS = {"stage", "boundary", "ms", "chain_overhead_share", "gflops",
                "tflops_per_sec", "gb_accessed", "gb_per_sec",
                "flops_per_byte"}


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small CPU ops (module initializations, the
    evaluator's per-tap sums), which PyTorch's intra-op threads only slow
    down when several test workers share the host: one thread each, the
    process's setting restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model(name):
    """``name`` at 32x32 in float32 with seeded weights whose batch-norm
    statistics come from a batch of the test frames, so activations stay
    O(1) through the deep stacks; returns (spec, state dict, frames)."""
    spec = build_model(name, ZOO_HPARAMS[name], SHAPE, 2)
    module = spec.module(generator=torch.Generator().manual_seed(3)).eval()
    x = torch.as_tensor(np.random.RandomState(1).rand(4, *SHAPE),
                        dtype=torch.float32)
    G.adapt_batch_norm(module, x)
    return spec, module.state_dict(), x


def load_segment(graph, state):
    return segment_module(graph, state, torch.device("cpu"), torch.float32)


@pytest.mark.parametrize("name", ZOO)
def test_auto_boundaries_equal_jax(name):
    jax_spec = jax_build_model(name, ZOO_HPARAMS[name], SHAPE, 2)
    spec = build_model(name, ZOO_HPARAMS[name], SHAPE, 2)
    bounds = auto_boundaries(spec.graph)
    assert bounds == jax_auto_boundaries(jax_spec.graph)
    assert bounds[-1] == ("head", spec.graph.output)
    for _, b in bounds[:-1]:
        spec.graph.cut(b)  # a boundary never severs an edge


def test_explicit_non_dominating_boundary_raises():
    """block_2_add also reads block_1_project_BN, across block_2_expand."""
    spec = build_model("mobilenetv2", ZOO_HPARAMS["mobilenetv2"], SHAPE, 2)
    with pytest.raises(ValueError, match="does not dominate"):
        stage_segments(spec, [("bad", "block_2_expand"),
                              ("head", spec.graph.output)])
    with pytest.raises(G.GraphError, match="severs"):
        spec.graph.segment("block_2_expand", "block_2_add")


@pytest.mark.parametrize("name", CHAINED)
def test_chained_segments_equal_full_forward_bitwise(name):
    spec, state, x = port_model(name)
    full = load_module(spec, state, torch.device("cpu"))
    with torch.inference_mode():
        want = full(x)
        out = x
        for _label, _b, _prev, graph in stage_segments(spec):
            out = load_segment(graph, state)(out)
    assert torch.equal(out, want)
    assert len(stage_segments(spec)) >= 3


@pytest.mark.parametrize("name", ("cnn0", "xception", "efficientnetb0"))
def test_segment_flops_sum_to_full_model(name):
    """efficientnetb0: efficientnetb7's graph at b0's widths (the stem a
    stage of its own, as ``serving_boundaries`` cuts it)."""
    spec = (build_efficientnet("b0", ZOO_HPARAMS["efficientnetb7"], SHAPE,
                               2) if name == "efficientnetb0"
            else build_model(name, ZOO_HPARAMS[name], SHAPE, 2))
    module = spec.module()
    state = module.state_dict()
    full = flops_per_frame(module, SHAPE, torch.float32, torch.device("cpu"))
    shapes = spec.layer_shapes(state)
    total = 0.0
    segs = stage_segments(spec, serving_boundaries(spec.graph))
    for _label, _b, prev, graph in segs:
        total += flops_per_frame(load_segment(graph, state),
                                 shapes[prev or G.INPUT][1:],
                                 torch.float32, torch.device("cpu"))
    assert full > 0
    assert total == full


@pytest.mark.parametrize("name", ("mobilenetv2", "xception"))
def test_segments_run_no_layer_of_their_prefix(name):
    """Hooks on every parameterized layer of each segment: the layers run
    are exactly the segment's own, all after its previous boundary, and
    together the segments run every parameterized layer of the model
    once."""
    spec, state, x = port_model(name)
    index = {n: i for i, n in enumerate(spec.graph.layer_names)}
    seen_all = []
    out = x
    for _label, boundary, prev, graph in stage_segments(spec):
        module = load_segment(graph, state)
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args, n=n: seen.append(n))
            for n, m in module.named_children()]
        with torch.inference_mode():
            out = module(out)
        for h in hooks:
            h.remove()
        lo = index[prev] if prev is not None else 0
        assert all(lo < index[n] <= index[boundary] for n in seen), (
            prev, boundary, seen)
        seen_all += seen
    assert seen_all == [s.name for s in spec.graph.layers
                        if s.module_fn is not None]


def test_attribute_stages_on_the_cpu_gives_the_jax_keys():
    spec, state, _ = port_model("cnn0")
    rows = attribute_stages(spec, state, batch=2, iters=1,
                            dtype=torch.float32, device="cpu",
                            verbose=False)
    assert [r["stage"] for r in rows] == [
        label for label, _ in auto_boundaries(spec.graph)]
    for r in rows:
        assert JAX_ROW_KEYS <= set(r)
        assert r["depthwise_launches"] == 0
        assert r["gb_accessed"] > 0
    total = sum(r["gflops"] for r in rows) * 1e9
    want = 2 * flops_per_frame(spec.module(), SHAPE, torch.float32,
                               torch.device("cpu"))
    assert total == pytest.approx(want, rel=1e-12)
