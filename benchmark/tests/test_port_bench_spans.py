"""The readers of the program's spans and counters on hand-built
reductions, and the host-fed serve cell on the CPU at a tiny size."""

import importlib
import json
import os
import time

import pytest
import torch

import run as bench_run
from harness import cells, spans
from harness.outcome import View
from harness.trace import Reduction

CPU = torch.device("cpu")
FIT = "cutoffvgg16-fit-cached"
HOST = "cutoffvgg16-serve-host"

# The entries that admit the host-fed cell to BENCHMARK.json. It stays out
# while its rate spreads over its bound (PERF.md, Open questions); its
# files and readers are held to these entries here.
HOST_ENTRY = {
    "name": HOST, "config": "cutoffvgg16", "traffic": "serve-host",
    "chips": 1,
    "why": "studies of 3500 and 5600 480x640 frames from pinned host memory "
           "through predict_probs at 2048, closed loop: ragged padding, "
           "staging copies and uploads"}
HOST_LISTS = ("serve_frames_per_s", "mfu.serve", "idle_share.serve",
              "b1_roofline.serve")
HOST_METRICS = [
    {"name": "staging_idle.serve", "unit": "%", "better": "lower",
     "source": "program_span", "layer": "serving engine",
     "moves": "serve_frames_per_s", "workloads": [HOST]},
    {"name": "padded_share.serve", "unit": "%", "better": "lower",
     "source": "program_counter", "layer": "serving engine",
     "moves": "serve_frames_per_s", "workloads": [HOST]}]


@pytest.fixture
def host_root(tmp_path):
    """A checkout's root whose BENCHMARK.json admits the host-fed cell."""
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(HOST_ENTRY)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in HOST_LISTS:
            m["workloads"].append(HOST)
    bench["per_layer"] += HOST_METRICS
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(cells.BENCH_DIR, tmp_path / "benchmark")
    return str(tmp_path)


def readers(cell, root=cells.ROOT):
    return {m.name: m.read for m in cells.load(cell, root=root).per_layer}


def reduction(ops, host, window=10.0):
    """A sub-window of ``window`` seconds holding device operations and
    host spans, each ``(start, end)`` (spans ``(name, start, end)``)."""
    busy = sum(e - s for s, e in spans.union(ops))
    return Reduction(window, busy, [("k", s, e - s) for s, e in ops],
                     [(n, s, e - s) for n, s, e in host])


EPOCH = [("train.epoch", 0.0, 10.0)]
CASES = {
    # Idle 0-2 and 8-10, both at the sub-window's ends, between the
    # epoch's start and its steps and after them.
    "gaps at the ends": (FIT, [(2, 8)], EPOCH + [
        ("train.epoch.steps", 2.0, 8.0)],
        {"boundary_idle.fit": 40.0, "replay_idle.fit": 0.0,
         "idle_share.fit": 40.0}),
    # Idle 1-9; steps 1-5 and 4-7 overlap: 1-7 counted once.
    "overlapping spans": (FIT, [(0, 1), (9, 10)], EPOCH + [
        ("train.epoch.steps", 1.0, 5.0), ("train.epoch.steps", 4.0, 7.0),
        ("graph.replay:train", 4.5, 5.5)],
        {"boundary_idle.fit": 20.0, "replay_idle.fit": 60.0,
         "idle_share.fit": 80.0}),
    # Idle 4-6, the steps from 5: half the gap each side.
    "a gap half inside a span": (FIT, [(0, 4), (6, 10)], EPOCH + [
        ("train.epoch.steps", 5.0, 10.0)],
        {"boundary_idle.fit": 10.0, "replay_idle.fit": 10.0,
         "idle_share.fit": 20.0}),
    # Idle 0.5-1, 4-6 and 7-10; the epochs 0.5-8 and 9-10; the
    # caller's 8-9 is in neither metric.
    "the caller's time": (FIT, [(0, 0.5), (1, 4), (6, 7)], [
        ("train.epoch", 0.5, 8.0), ("train.epoch", 9.0, 10.0),
        ("train.epoch.tables", 0.5, 1.5), ("train.epoch.steps", 1.5, 5.0),
        ("train.epoch.steps", 6.5, 7.5)],
        {"boundary_idle.fit": 30.0, "replay_idle.fit": 15.0,
         "idle_share.fit": 55.0}),
    # Idle 0-2 and 8-10; padding 0-2 and a wait 1-3 overlap, a copy 8-9.
    "staging": (HOST, [(2, 8)], [
        ("serve.pad", 0.0, 2.0), ("staging.wait", 1.0, 3.0),
        ("staging.copy", 8.0, 9.0), ("serve.readback", 9.0, 10.0)],
        {"staging_idle.serve": 30.0, "idle_share.serve": 40.0}),
    # A program without the spans: the readers find nothing.
    "no spans": (FIT, [(2, 8)], [("run_epoch", 0.0, 10.0)],
                 {"boundary_idle.fit": None, "replay_idle.fit": None,
                  "idle_share.fit": 40.0}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_span_readers_on_a_hand_built_reduction(case, host_root):
    cell, ops, host, want = CASES[case]
    kind = "fit" if cell == FIT else "serve"
    read = readers(cell, host_root)
    view = View(kind, reduction(ops, host))
    got = {name: read[name](view) for name in want}
    assert got == {k: (None if v is None else pytest.approx(v))
                   for k, v in want.items()}
    if kind == "fit" and got["boundary_idle.fit"] is not None:
        assert (got["boundary_idle.fit"] + got["replay_idle.fit"]
                <= got["idle_share.fit"] + 1e-9)
    # A view of the other kind reads nothing.
    other = View("serve" if kind == "fit" else "fit", view.trace)
    assert all(read[name](other) is None for name in want
               if name not in ("idle_share.fit", "idle_share.serve"))


@pytest.mark.parametrize("work,want", [
    ({"rows_run": 10240, "rows_padded": 1140}, 100 * 1140 / 10240),
    ({"rows_run": 4096, "rows_padded": 0}, 0.0),
    ({}, None)])
def test_padded_share_reads_the_counters(work, want, host_root):
    got = readers(HOST, host_root)["padded_share.serve"](
        View("serve", reduction([], []), work=work))
    assert got == (None if want is None else pytest.approx(want))


def test_interval_arithmetic():
    a = spans.union([(3, 5), (0, 1), (0.5, 2), (6, 6)])
    assert a == [(0, 2), (3, 5)]
    assert spans.minus(a, [(1, 4)]) == [(0, 1), (4, 5)]
    assert spans.minus(a, [(-1, 9)]) == []
    assert spans.overlap(a, [(1, 3.5), (4.5, 9)]) == pytest.approx(2.0)


def test_the_host_cell_is_found_by_name(host_root):
    cell = cells.load(HOST, root=host_root)
    assert "serve_host" in cell.traffic.values()
    assert cell.traffic["study_frames"] == [3500, 5600]
    assert cell.chips == 1 and cell.config["name"] == "cutoffvgg16"
    assert set(cell.limits) == {"logit_gap"}
    assert [m.name for m in cell.end_to_end] == ["serve_frames_per_s",
                                                  "setup_s"]
    assert [m.name for m in cell.per_layer] == [
        "mfu.serve", "idle_share.serve", "b1_roofline.serve",
        "staging_idle.serve", "padded_share.serve"]
    # The mix's padding: 9100 frames in 10240 rows.
    chunk = cell.traffic["chunk"]
    rows = sum(-(-n // chunk) * chunk for n in cell.traffic["study_frames"])
    assert rows == 10240
    for name in ("cutoffvgg16-serve-study", "mobilenetv2-serve-study"):
        assert "staging_idle.serve" not in readers(name, host_root)
    assert {"boundary_idle.fit", "replay_idle.fit"} <= set(readers(FIT))


@pytest.fixture
def tiny_host(host_root):
    cell = cells.load(HOST, root=host_root)
    cell.traffic.update(chunk=4, study_frames=[5, 7], frame_hw=[96, 128])
    return cell


def drive(cell, traced, seed=2**32 + 5):
    module = importlib.import_module("harness.serve_host")
    outcome = module.run(cell, seed, 0.2, traced, CPU, time.perf_counter())
    return bench_run.result_line(cell, outcome, traced, CPU), outcome


def test_the_host_studies_are_the_seeds(tiny_host):
    from harness import serve_host
    t = tiny_host.traffic
    a, b = (serve_host.studies(2**33 + 1, t, CPU) for _ in range(2))
    assert [s.shape[0] for s in a] == [5, 7]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], serve_host.studies(2**33 + 2, t,
                                                    CPU)[0])
    assert a[0].dtype == torch.uint8 and a[0].device == CPU


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_host_run_is_correct(traced, tiny_host):
    result, outcome = drive(tiny_host, traced)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["attempted"] % 12 in (0, 5)
    if not traced:
        assert set(result["metrics"]) == {"serve_frames_per_s", "setup_s"}
        return
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # 5 and 7 frames at 4: 3 and 1 zero rows of 16.
    assert got["padded_share.serve"] == pytest.approx(25.0)
    assert 0.0 <= got["staging_idle.serve"] <= got["idle_share.serve"]
    assert outcome.view.frames == 12
    # The cell's work counts stand beside the counters: the model's share
    # of the peak is read.
    assert got["mfu.serve"] > 0.0
    assert outcome.view.work["flops_forward"] > 0


def test_a_wrong_host_answer_is_caught(monkeypatch, tiny_host):
    from ab_line_classifier_torch.predict.predict import Predictor
    predict_probs = Predictor.predict_probs

    def altered(self, frames):
        out = predict_probs(self, frames)
        out[-1] = out[-1] < out[-1].max()  # another class, surely
        return out

    monkeypatch.setattr(Predictor, "predict_probs", altered)
    result, outcome = drive(tiny_host, False)
    assert not result["correct"]
    assert outcome.failed > 0


def test_the_host_control_is_not_correct(tiny_host):
    from harness import serve_host
    cell = tiny_host
    cell.traffic.update(study_frames=[70, 58], frame_hw=[480, 640])
    got = serve_host.control(cell, 2**32 + 11, CPU)["control"]
    assert got["logit_gap"] > cell.limits["logit_gap"], got
