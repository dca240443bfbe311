"""The serve driver: a backlog of studies served offline through
``Predictor.forward`` in a closed loop over a pool of device-resident
chunks, dispatched ahead by ``dispatch_ahead`` chunks.

Set-up: the seeded weights and chunks, the predictor, and three calls on
the chunk shape (eager, capture, replay). Window: chunks in turn until
``seconds`` have passed, every answer kept; the rate is all frames served
over the host seconds from the window's start to the synchronize after its
last chunk. The traced run then profiles a sub-window of chunks. After the
window and the peak memory are read and the predictor is dropped, the
reference serves each chunk once, and every kept answer is compared with
its chunk's."""

from __future__ import annotations

import collections
import math
import time
from typing import Dict, List

import torch

import reference
from reference import serve as ref_serve

from harness import check, gen, weights
from harness import trace as T
from harness import work as W
from harness.outcome import (Outcome, View, is_cuda, launch_note,
                             memory_peak, release, set_up, sync)


def _issue(predictor, pool, kept: Dict[int, List[torch.Tensor]],
           depth: int, device, first: int, *, deadline=None,
           count=None) -> int:
    """Serve chunks in turn from ``pool[first % len(pool)]`` until
    ``deadline`` (host clock) or ``count`` chunks, at most ``depth`` in
    flight; returns the chunks served, after a synchronize."""
    pending = collections.deque()
    i = 0
    while count is None or i < count:
        if deadline is not None and time.perf_counter() >= deadline:
            break
        if len(pending) >= depth:
            pending.popleft().synchronize()
        k = (first + i) % len(pool)
        kept[k].append(predictor.forward(pool[k]))
        if is_cuda(device):
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
        i += 1
    sync(device)
    return i


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import launches
    from ab_line_classifier_torch.predict.predict import Predictor

    cfg, tr = cell.config, cell.traffic
    marks = [("imports", time.perf_counter() - t_start)]
    ref = reference.build(cfg)
    state = weights.make(ref, cfg, seed, device)
    pool = gen.serve_pool(seed, tr, device)
    sync(device)
    marks.append(("weights and frames", time.perf_counter() - t_start))
    spec = build_model(cfg["model_def"], cfg["hparams"],
                       tuple(cfg["input_shape"]), cfg["n_classes"],
                       mixed_precision=cfg["mixed_precision"])
    predictor = Predictor(spec, state, batch_size=tr["chunk"], device=device)
    for _ in range(3):  # eager, capture, replay
        predictor.forward(pool[0])
    sync(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))

    kept = {k: [] for k in range(len(pool))}
    depth = tr["dispatch_ahead"]
    t0 = time.perf_counter()
    calls = _issue(predictor, pool, kept, depth, device, 0,
                   deadline=t0 + seconds)
    window_s = time.perf_counter() - t0
    e2e = {"setup_s": setup_s,
           "serve_frames_per_s": calls * tr["chunk"] / window_s}

    view, notes = View("serve"), [set_up(marks)]
    if traced:
        n = max(2, math.ceil(tr["trace_seconds"] * calls / window_s))
        before = launches.counts()
        with T.recording(device) as rec:
            sync(device)
            with T.window():
                _issue(predictor, pool, kept, depth, device, calls, count=n)
        view.trace = rec["reduction"]
        view.frames = n * tr["chunk"]
        notes += launch_note(before, launches.counts(), view.trace,
                             cell.per_layer)
    peak = memory_peak(device)
    del predictor
    release(device)

    view.work = W.cell_work(ref, cfg, tr)
    ref = ref.to(device)
    ref.load_state_dict(state)
    gaps = check.AnswerGap()
    with reference.exact_float32():
        for k, chunk in enumerate(pool):
            gaps.add(kept[k], *ref_serve.probabilities(ref, cfg, chunk))
    notes.append(f"compared {gaps.rows} served answers")
    over = gaps.over(cell.limits["logit_gap"])
    return Outcome(e2e, calls * tr["chunk"], over,
                   {"logit_gap": gaps.logit_gap()}, view, peak, notes)
