"""The benchmark's plain EfficientNet reference (``benchmark/reference/
efficientnet.py``) against the port's ``efficientnetb7`` on the CPU, the
seeded stem statistics the benchmark draws for it, and its work count at
the cell's 600x600."""

import json
import os
import sys

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import reference  # noqa: E402
from harness import gen, weights, work  # noqa: E402
from reference.preprocess import scale_input  # noqa: E402

from ab_line_classifier_torch.models import build_model  # noqa: E402

CPU = torch.device("cpu")

# float32 on both sides: the port's batch norms and stem run other
# formulas than the reference's (F.batch_norm, a reciprocal multiply for
# rescaling_1), so the softmax differs by rounding alone, under 2e-7 over
# 55 blocks; bfloat16 moves it by about 3e-3.
TOLERANCE = 2e-6


def config(hw):
    with open(os.path.join(BENCH, "configs", "efficientnetb7.json")) as f:
        cfg = json.load(f)
    cfg["input_shape"] = [hw, hw, 3]
    return cfg


def test_reference_is_the_ports_efficientnetb7_in_float32():
    cfg = config(64)  # every width and block of B7, the input cut
    ref = reference.build(cfg)
    state = weights.make(ref, cfg, 2**32 + 7, CPU)
    ref.load_state_dict(state)
    port = build_model(cfg["model_def"], cfg["hparams"],
                       tuple(cfg["input_shape"]), cfg["n_classes"]).module()
    assert set(port.state_dict()) == set(state)
    assert sum(v.numel() for k, v in state.items()
               if not k.endswith(("running_mean", "running_var"))
               and not k.startswith("normalization.")) == cfg["parameters"]
    port.load_state_dict(state)
    port.eval()
    frames = gen.frames(gen.generator(1, "frames", CPU), 2, (64, 64),
                        (0.15, 1.0), CPU)
    with torch.no_grad():
        want = torch.softmax(ref(scale_input(frames, "tf"))[0], -1)
        got = port(frames.to(torch.float32))  # raw [0, 255]: identity
        low = port.to(torch.bfloat16)(frames.to(torch.bfloat16)).float()
    assert torch.allclose(got, want, atol=TOLERANCE, rtol=0), (got, want)
    assert not torch.allclose(low, want, atol=TOLERANCE, rtol=0)
    assert float((want[0] - want[1]).abs().max()) > 1e-3  # told apart


@pytest.mark.parametrize("seed", [3, 2**32 + 11, 3100000001])
def test_drawn_stem_variances_are_positive(seed):
    cfg = config(16)
    cfg["weights"]["calibration"]["frames"] = 2  # the draw, not the stats
    state = weights.make(reference.build(cfg), cfg, seed, CPU)
    var = state["normalization.variance"]
    spec = cfg["weights"]
    assert float(var.min()) > spec["bias_mean"] - 6 * spec["bias_std"] > 0
    assert not torch.equal(var, torch.ones_like(var))


def test_work_at_600_is_the_configs():
    cfg = config(600)
    model = reference.build(cfg)
    flops = work.flops_per_frame(model, cfg["input_shape"])
    assert flops == pytest.approx(cfg["gflop_per_frame_forward"] * 1e9,
                                  rel=1e-12)
    layers = work.depthwise_layers(model, cfg["input_shape"])
    assert len(layers) == 51
    assert {k for _, k in layers} == {3, 5}
    assert max(s[1] for s, _ in layers) == 300
