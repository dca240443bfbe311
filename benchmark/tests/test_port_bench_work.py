"""Work counts, peaks and the trace reduction behind the per-layer
metrics."""

import json

import pytest
import torch

import reference
from harness import cells, trace, work
from harness.outcome import View

CONFIGS = {n: json.load(open(f"{cells.BENCH_DIR}/configs/{n}.json"))
           for n in ("cutoffvgg16", "mobilenetv2")}


@pytest.mark.parametrize("name,gflop", [("cutoffvgg16", 6.096421888),
                                        ("mobilenetv2", 0.137058432)])
def test_forward_flops_match_the_layer_shapes(name, gflop):
    cfg = CONFIGS[name]
    got = work.flops_per_frame(reference.build(cfg), cfg["input_shape"])
    assert got == pytest.approx(gflop * 1e9, rel=1e-12)
    assert cfg["gflop_per_frame_forward"] == pytest.approx(gflop)


def test_vgg_flops_by_hand():
    # 2 * out elements * in channels * 9 per 3x3 conv, + the dense layer.
    convs = [(128, 3, 64), (128, 64, 64), (64, 64, 128), (64, 128, 128),
             (32, 128, 256), (32, 256, 256), (32, 256, 256)]
    want = sum(2 * s * s * co * ci * 9 for s, ci, co in convs) + 2 * 256 * 2
    cfg = CONFIGS["cutoffvgg16"]
    assert work.flops_per_frame(reference.build(cfg),
                                cfg["input_shape"]) == want


def test_training_flops_follow_the_trainable_layers():
    cfg = CONFIGS["cutoffvgg16"]
    m = reference.build(cfg)
    fwd = work.flops_per_frame(m, cfg["input_shape"])
    c3 = 2 * 32 * 32 * 256 * 256 * 9
    # block3_conv3: weight and input gradients; block3_conv2: weight only;
    # logits: weight and input.
    want = fwd + 2 * c3 + c3 + 2 * (2 * 256 * 2)
    got = work.flops_per_frame(m, cfg["input_shape"],
                               cfg["train_phase"]["trainable"], True)
    assert got == want
    cfg = CONFIGS["mobilenetv2"]
    m = reference.build(cfg)
    head = 2 * (96 * 32 + 32 * 2)
    assert work.flops_per_frame(m, cfg["input_shape"], ["fc0", "logits"],
                                True) == pytest.approx(
        work.flops_per_frame(m, cfg["input_shape"]) + head + 2 * 32 * 2)


def test_b1_bound_matches_the_kernel_table():
    # PERF.md's B1 row: 0.2103 ms at 2048 x 480x640 -> 128x128 bf16, and
    # 0.0901 ms at 2048 x 128x128.
    assert work.preprocess_bound_s(2048, (480, 640), (128, 128), "tf",
                                   2) * 1e3 == pytest.approx(0.2103,
                                                             abs=5e-5)
    assert work.preprocess_bound_s(2048, (128, 128), (128, 128), "tf",
                                   2) * 1e3 == pytest.approx(0.0901,
                                                             abs=5e-5)


def test_b2_bound_matches_the_kernel_table():
    cfg = CONFIGS["mobilenetv2"]
    layers = work.depthwise_layers(reference.build(cfg), cfg["input_shape"])
    assert len(layers) == 10
    assert work.depthwise_forward_bound_s(layers, 2048, 2) * 1e3 == \
        pytest.approx(1.3422, abs=5e-5)


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def hand_trace():
    """A 1000 us sub-window: kernels at 100-300 and 250-400 (overlapping),
    a memcpy at 600-700, a kernel crossing the end at 950-1050; host ops
    around them."""
    return {"traceEvents": [
        _event(trace.WINDOW, "user_annotation", 1000, 1000),
        _event("void preprocess_kernel<bf16>", "kernel", 1100, 200),
        _event("conv", "kernel", 1250, 150),
        _event("Memcpy DtoD", "gpu_memcpy", 1600, 100),
        _event("void depthwise_tiled<3>", "kernel", 1950, 100),
        _event("outside", "kernel", 3000, 50),
        _event("cudaGraphLaunch", "cuda_runtime", 1400, 150),
        _event("aten::copy_", "cpu_op", 1420, 20),
        _event("run_epoch", "python_function", 1000, 900),
    ]}


def test_reduction_of_a_hand_made_trace():
    red = trace.reduce(hand_trace())
    assert red.window_s == pytest.approx(1e-3)
    # union: 100-400 (300) + 600-700 (100) + 950-1000 (50)
    assert red.busy_s == pytest.approx(450e-6)
    assert red.kernel_time("preprocess_kernel") == (1, pytest.approx(2e-4))
    assert red.kernel_time("depthwise_tiled")[1] == pytest.approx(5e-5)
    assert red.top_ops(2)[0] == ["void preprocess_kernel<bf16>",
                                 pytest.approx(2e-4)]
    gaps = red.idle_gaps()
    # 700-950 under run_epoch, 400-600 from a graph launch, 0-100.
    assert gaps == [["host in run_epoch", pytest.approx(2.5e-4)],
                    ["host in cudaGraphLaunch", pytest.approx(2e-4)],
                    ["host in run_epoch", pytest.approx(1e-4)]]


def test_readers_on_a_hand_made_trace():
    red = trace.reduce(hand_trace())
    serve = cells.load("mobilenetv2-serve-study")
    view = View("serve", red, frames=2048,
                work={"flops_forward": 1e9, "b1_launch_bound_s": 1e-4,
                      "b2_layers": 1, "b2_forward_bound_s": 2.5e-5})
    got = {m.name: m.read(view) for m in serve.per_layer}
    assert got["idle_share.serve"] == pytest.approx(55.0)
    assert got["b1_roofline.serve"] == pytest.approx(50.0)
    assert got["b2_roofline.serve"] == pytest.approx(50.0)
    assert got["mfu.serve"] == pytest.approx(
        100 * 2048 * 1e9 / 1e-3 / 989e12)
    fit = cells.load("cutoffvgg16-fit-cached")
    got = {m.name: m.read(view) for m in fit.per_layer}
    assert all(v is None for v in got.values())  # a serve view


def test_a_reader_finds_nothing_without_its_kernel():
    red = trace.reduce({"traceEvents": [
        _event(trace.WINDOW, "user_annotation", 0, 100),
        _event("conv", "kernel", 10, 20)]})
    cell = cells.load("cutoffvgg16-serve-study")
    view = View("serve", red, frames=1, work={"flops_forward": 1.0,
                                              "b1_launch_bound_s": 1.0})
    got = {m.name: m.read(view) for m in cell.per_layer}
    assert got["b1_roofline.serve"] is None
    assert "b2_roofline.serve" not in got


def test_profiler_recording_on_the_cpu():
    with trace.recording("cpu") as rec:
        with trace.window():
            torch.ones(64).sum()
    red = rec["reduction"]
    assert red.window_s > 0 and red.busy_s == 0.0


def test_traced_launches_are_held_to_the_counted_ones():
    """A kernel's reader names its launch counter and its trace names: the
    run says where the two differ, and of no kernel no metric reads."""
    from harness.outcome import launch_note

    red = trace.reduce(hand_trace())
    metrics = cells.load("mobilenetv2-serve-study").per_layer
    assert launch_note({}, {"preprocess": 1, "depthwise": 1}, red,
                       metrics) == []
    notes = launch_note({"preprocess": 3}, {"preprocess": 5,
                                            "depthwise": 1}, red, metrics)
    assert notes == ["trace: 1 preprocess kernels recorded, 2 launched in "
                     "the traced sub-window"]
    fit = cells.load("cutoffvgg16-fit-cached").per_layer
    assert launch_note({}, {"preprocess": 9}, red, fit) == []
