"""PyTorch port, the profiler spans of the serving engine and the training
loop (``utils/profiling.annotate``): free when no profiler records, and,
under a CPU profiler, nested as the trace readers of the benchmark expect;
and the serving engine's row counters. The module imports only torch,
numpy and the port, so its card test runs on a machine without JAX::

    python -m pytest tests/test_torch_spans.py --noconftest -m cuda
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ab_line_classifier_torch.data.pipeline import DeviceCachedDataset
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.predict.predict import Predictor
from ab_line_classifier_torch.train.loop import Trainer
from ab_line_classifier_torch.utils import profiling

HP = {"LR": 1e-3, "DROPOUT": 0.1, "L2_LAMBDA": 1e-4, "NODES_DENSE0": 8,
      "KERNEL_SIZE": 3, "STRIDES": 2, "MAXPOOL_SIZE": 2, "BLOCKS": 1,
      "INIT_FILTERS": 4, "FILTER_EXP_BASE": 2}
SHAPE = (16, 16, 3)
BATCH = 4


def _spec():
    return build_model("cnn0", HP, SHAPE, 2)


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n,) + SHAPE).astype(np.uint8)


def _predictor(device="cpu"):
    spec = _spec()
    return Predictor(spec, spec.module().state_dict(), batch_size=BATCH,
                     compute_dtype=torch.float32, device=device)


def _spans(tmp_path, run, cuda=False, cat="user_annotation"):
    """``(name, start, end)`` of every host event of category ``cat``
    (default: the profiler regions) that ``run()`` made, in order of
    start, from the chrome trace."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {cat, "user_annotation"}
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in cats),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, parent):
    """The spans inside the first span named ``parent``, in order."""
    _, lo, hi = next(s for s in spans if s[0] == parent)
    return [s for s in spans if lo <= s[1] and s[2] <= hi
            and s[0] != parent]


class _Counted:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counted.entered += 1

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("recording", [False, True])
def test_annotate_enters_a_region_only_while_a_profiler_records(
        monkeypatch, recording):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.entered = 0
    if recording:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.annotate("x"):
                pass
        assert _Counted.entered == 1
        return
    ctx = profiling.annotate("x")
    assert ctx is profiling.annotate("y")  # one shared no-op
    with ctx:
        pass
    # The program's own spans, serving and a training epoch, enter none.
    _predictor().predict_probs(_frames(2 * BATCH + 1))
    trainer = Trainer(_spec(), seed=1, device="cpu")
    trainer.begin_phase(0, trainer.spec.phases[0])
    trainer.run_epoch(DeviceCachedDataset.from_arrays(
        _frames(2 * BATCH), np.arange(2 * BATCH) % 2, "cpu"), BATCH,
        train=True)
    assert _Counted.entered == 0


def test_the_forward_holds_its_input_program_and_output(tmp_path):
    predictor = _predictor()
    frames = torch.from_numpy(_frames(BATCH))
    spans = _spans(tmp_path, lambda: predictor.forward(frames))
    inner = [n for n, _, _ in _inside(spans, "serve.forward")]
    top = [n for n in inner if n in ("serve.input", "graph.run:serve",
                                     "serve.output")]
    assert top == ["serve.input", "graph.run:serve", "serve.output"]
    # The body's own regions lie inside the program's span.
    assert [n for n, _, _ in _inside(spans, "graph.run:serve")] == [
        "predict.preprocess", "predict.model"]
    assert predictor.summaries()["4x16x16x3"]["name"] == "serve"


def test_a_cached_epoch_holds_its_phases_in_turn(tmp_path):
    trainer = Trainer(_spec(), seed=1, device="cpu")
    trainer.begin_phase(0, trainer.spec.phases[0])
    ds = DeviceCachedDataset.from_arrays(_frames(3 * BATCH - 1),
                                         np.arange(3 * BATCH - 1) % 2,
                                         "cpu")
    spans = _spans(tmp_path, lambda: trainer.run_epoch(ds, BATCH,
                                                       train=True))
    phases = [s for s in _inside(spans, "train.epoch")
              if s[0].startswith("train.epoch.")]
    assert [n for n, _, _ in phases] == [
        "train.epoch.tables", "train.epoch.reset", "train.epoch.steps",
        "train.epoch.readback"]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    steps = [n for n, _, _ in _inside(spans, "train.epoch.steps")]
    assert steps.count("graph.run:train") == 3
    assert trainer.epoch_programs["train"].step.summary()["name"] == "train"


@pytest.mark.parametrize("n,run,padded", [
    (2 * BATCH + 1, 3 * BATCH, BATCH - 1),
    (2 * BATCH, 2 * BATCH, 0)])
def test_the_predictor_counts_rows_run_and_padded(n, run, padded):
    predictor = _predictor()
    probs = predictor.predict_probs(_frames(n))
    assert probs.shape == (n, 2)
    assert (predictor.rows_run, predictor.rows_padded) == (run, padded)


@pytest.mark.cuda
def test_on_the_card_each_call_is_one_span_and_staging_is_named(tmp_path):
    """On CUDA: an eager call, a capture and replays, each one span, a
    replay's ``cudaGraphLaunch`` inside its span; host frames through the
    pinned staging under ``staging.copy`` (and ``staging.wait`` once a
    slot comes round again)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and pinned staging")
    predictor = _predictor("cuda")
    spans = _spans(tmp_path, lambda: predictor.predict_probs(
        _frames(5 * BATCH - 2)), cuda=True, cat="cuda_runtime")
    names = [n for n, _, _ in spans]
    assert [n for n in names if n.startswith("graph.")] == [
        "graph.eager:serve", "graph.capture:serve"] + [
        "graph.replay:serve"] * 3
    replays = [s for s in spans if s[0] == "graph.replay:serve"]
    for _, lo, hi in replays:
        assert any(n == "cudaGraphLaunch" and lo <= a and b <= hi
                   for n, a, b in spans)
    assert names.count("staging.copy") == 5
    assert names.count("staging.wait") == 3
    assert names.count("serve.pad") == names.count("serve.readback") == 5
    assert (predictor.rows_run, predictor.rows_padded) == (5 * BATCH, 2)
