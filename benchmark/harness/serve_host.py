"""Serving from host memory: a backlog of studies held in host memory (pinned
on CUDA), each served whole through ``Predictor.predict_probs`` in a
closed loop, one call at a time, the studies in turn. Inside a call the
predictor pads the ragged last chunk, copies each chunk through its
pinned staging into the program's fixed input and reads chunk k back
while chunk k+1 runs (``drain_behind``): the upload and the padding are
part of what the user waits for.

Set-up: the seeded weights; the studies (lengths fixed by the mix, frames
made on the device from the seed in blocks and copied to the host); the
predictor, and one call on the first three chunks of the longest study
(the chunk shape's eager call, its capture and a replay; both pinned
buffers of the staging; a ragged chunk where the study has one). Window:
studies in turn until ``seconds`` have passed, every answer kept; the rate
is the studies' frames (the padding left out) over the host seconds. The
traced run then profiles one pass over every study, and hands the readers
the predictor's row counters over it (``rows_run``, ``rows_padded``) where
the program keeps them, beside the cell's work counts. After the window
and the peak memory are read and the predictor is dropped, the reference
serves each study once, and every kept answer is compared with its
study's."""

from __future__ import annotations

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

COUNTERS = ("rows_run", "rows_padded")


def studies(seed: int, traffic: dict, device,
            block: int = 256) -> List[torch.Tensor]:
    """uint8 ``[n, H, W, 3]`` host tensors, one a length of
    ``study_frames``: the seed's frames made on ``device`` in blocks of
    ``block`` and copied into host memory, pinned where ``device`` is a
    card."""
    g = gen.generator(seed, "frames", device)
    h, w = traffic["frame_hw"]
    out = []
    for n in traffic["study_frames"]:
        host = torch.empty((n, h, w, 3), dtype=torch.uint8,
                           pin_memory=is_cuda(device))
        for i in range(0, n, block):
            k = min(block, n - i)
            host[i:i + k].copy_(gen.frames(g, k, (h, w),
                                           traffic["brightness"], device))
        out.append(host)
    return out


def reference_answers(ref, cfg: dict, study: torch.Tensor, device,
                      block: int = 2048):
    """The reference's probabilities of a host study and each frame's
    logit scale (``reference.serve.probabilities``), ``block`` frames on
    the device at a time."""
    probs, scale = [], []
    for i in range(0, study.shape[0], block):
        p, s = ref_serve.probabilities(ref, cfg,
                                       study[i:i + block].to(device))
        probs.append(p)
        scale.append(s)
    return torch.cat(probs), torch.cat(scale)


def counters(predictor) -> Dict[str, int]:
    """The predictor's row counters, where the program keeps them."""
    return {k: getattr(predictor, k) for k in COUNTERS
            if hasattr(predictor, k)}


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> Outcome:
    from ab_line_classifier_torch.models import build_model
    from ab_line_classifier_torch.ops import launches
    from ab_line_classifier_torch.predict.predict import Predictor

    cfg, tr = cell.config, cell.traffic
    marks = [("imports", time.perf_counter() - t_start)]
    ref = reference.build(cfg)
    state = weights.make(ref, cfg, seed, device)
    pool = studies(seed, tr, device)
    arrays = [s.numpy() for s in pool]
    sync(device)
    marks.append(("weights and studies", time.perf_counter() - t_start))
    spec = build_model(cfg["model_def"], cfg["hparams"],
                       tuple(cfg["input_shape"]), cfg["n_classes"],
                       mixed_precision=cfg["mixed_precision"])
    predictor = Predictor(spec, state, batch_size=tr["chunk"], device=device)
    # Eager, capture, replay; both pinned buffers.
    predictor.predict_probs(max(arrays, key=len)[:3 * tr["chunk"]])
    sync(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))

    kept = {k: [] for k in range(len(pool))}
    calls = frames = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while calls == 0 or time.perf_counter() < deadline:
        k = calls % len(pool)
        kept[k].append(torch.from_numpy(predictor.predict_probs(arrays[k])))
        frames += len(arrays[k])
        calls += 1
    window_s = time.perf_counter() - t0
    e2e = {"setup_s": setup_s, "serve_frames_per_s": frames / window_s}

    view, notes = View("serve"), [set_up(marks)]
    rows = {}
    if traced:
        before, counted = counters(predictor), launches.counts()
        with T.recording(device) as rec:
            sync(device)
            with T.window():
                for k, a in enumerate(arrays):
                    kept[k].append(torch.from_numpy(
                        predictor.predict_probs(a)))
                sync(device)
        view.trace = rec["reduction"]
        view.frames = sum(len(a) for a in arrays)
        rows = {k: v - before[k] for k, v in counters(predictor).items()}
        notes += launch_note(counted, launches.counts(), view.trace,
                             cell.per_layer)
    peak = memory_peak(device)
    del predictor
    release(device)

    view.work = {**W.cell_work(ref, cfg, tr), **rows}
    ref = ref.to(device)
    ref.load_state_dict(state)
    gaps = check.AnswerGap()
    with reference.exact_float32():
        for k, study in enumerate(pool):
            gaps.add(kept[k], *reference_answers(ref, cfg, study, device))
    notes.append(f"compared {gaps.rows} served answers in {calls} studies")
    over = gaps.over(cell.limits["logit_gap"])
    return Outcome(e2e, frames, over, {"logit_gap": gaps.logit_gap()}, view,
                   peak, notes)


def control(cell, seed: int, device) -> dict:
    """The control's reading of one seed (as ``benchmark/control.py``
    reads the other serve cells): the reference computed in float8 put in
    the program's place, each study served once and judged against the
    float32 reference."""
    cfg = cell.config
    ref = reference.build(cfg)
    state = weights.make(ref, cfg, seed, device)
    ref = ref.to(device)
    ref.load_state_dict(state)
    low = reference.build(cfg, "fp8").to(device)
    low.load_state_dict(state)
    gaps = check.AnswerGap()
    with reference.exact_float32():
        for study in studies(seed, cell.traffic, device):
            gaps.add([reference_answers(low, cfg, study, device)[0]],
                     *reference_answers(ref, cfg, study, device))
    return {"control": {"logit_gap": gaps.logit_gap()}}
