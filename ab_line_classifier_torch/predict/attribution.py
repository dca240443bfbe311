"""Per-stage serving attribution: where a model's device time goes (port of
the JAX package's ``predict/attribution.py``).

Each stage of a zoo model runs as a module of its own and is timed on the
device:

- :func:`auto_boundaries` groups layers into stages by the zoo's naming
  convention (``block{N}...``, ``block_{N}...``, ``stage{N}...``) and puts
  each boundary on a graph dominator, so no residual or squeeze-excite edge
  crosses it: the JAX package's rule, labels and regex.
- :func:`stage_segments` builds each stage as :meth:`LayerGraph.segment`
  ``(prev, boundary)``: a graph of the stage's layers alone, its input
  node standing for the previous boundary's activation. PyTorch runs
  eagerly and removes no dead code, so the JAX package's way (the whole
  graph cut at the boundary, the previous boundary overridden, XLA
  dropping the prefix) would recompute the whole prefix in every segment
  here. Chaining the segments gives the full forward bit for bit
  (``tests/test_torch_attribution.py``).
- :func:`attribute_stages` times each segment on CUDA as a CUDA graph
  replayed L and 2L times under CUDA events: the difference over L is one
  execution with the fixed cost of the measurement removed, and the same
  for a graph of one tiny kernel (the null graph) is subtracted, so what
  is left is the stage's device time without the replay's own launch.
  On the CPU the same differencing runs on the host clock (no device
  metric).

The FLOP and byte columns are defined from layer shapes, not from a
compiler's cost analysis as in the JAX package (XLA's ``cost_analysis``),
so they are not comparable with its numbers: ``gflops`` counts 2 per
multiply-add of the convs, depthwise convs and dense layers (as
``benchmark.flops_per_frame``), elementwise work not counted;
``gb_accessed`` is the eager traffic, every layer reading each of its
inputs and writing its output once (activations in the compute dtype,
identity dropout not counted) plus each parameter and buffer read once in
the dtype the module holds it in.

    python -m ab_line_classifier_torch.predict.attribution \\
        --model efficientnetb7 --batch 512 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import graph as G
from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.ops import launches
from ab_line_classifier_torch.predict.benchmark import (
    build_zoo, clip_inference_benchmark, flops_per_frame, seeded_state, timers)

_STAGE_RE = re.compile(r"^(?:conv2d_)?(block_?|stage)(\d+)")

Segment = Tuple[str, str, Optional[str], G.LayerGraph]


def _dominator_indices(graph: G.LayerGraph) -> List[bool]:
    """``dom[i]``: does layer ``i`` dominate the rest of the graph? True iff
    every later layer's inputs all sit at index >= i, so the whole
    downstream computation flows through layer i alone. Only such layers
    are valid segment boundaries: across any other one a later layer reads
    an earlier activation, which the segment would have to recompute."""
    index_of = {s.name: i for i, s in enumerate(graph.layers)}
    n = len(graph.layers)
    dom = [False] * n
    min_inp = n
    for i in range(n - 1, 0, -1):
        dom[i] = min_inp >= i
        for inp in graph.layers[i].inputs:
            min_inp = min(min_inp, index_of[inp])
    return dom


def auto_boundaries(graph: G.LayerGraph) -> List[Tuple[str, str]]:
    """``[(stage label, boundary layer name), ...]`` in topological order.

    Layers whose names carry a stage tag group by its number. Each stage's
    boundary is the LAST dominator between its final tagged layer and the
    next stage's first tagged layer (the residual join or pool glue belongs
    to the earlier stage); the final tagged stage takes the FIRST dominator
    at or after its last tagged layer, so the head stays its own. A stage
    with no dominator in its window merges into the next; leading untagged
    layers fold into the first stage; the rest is ``head``, bounded by the
    graph output."""
    layers = graph.layers
    first_idx: Dict[str, int] = {}
    last_idx: Dict[str, int] = {}
    labels: Dict[str, str] = {}
    order: List[str] = []
    for i, s in enumerate(layers):
        m = _STAGE_RE.match(s.name)
        if not m:
            continue
        key = m.group(2)
        if key not in first_idx:
            first_idx[key] = i
            order.append(key)
            labels[key] = m.group(1).rstrip("_") + key
        last_idx[key] = i
    if not order:
        raise ValueError(
            "no stage-tagged layers found; pass explicit boundaries")

    dom = _dominator_indices(graph)
    out: List[Tuple[str, str]] = []
    for pos, key in enumerate(order):
        last = pos + 1 == len(order)
        window_end = len(layers) if last else first_idx[order[pos + 1]]
        idxs = (range(last_idx[key], window_end) if last
                else range(window_end - 1, last_idx[key] - 1, -1))
        boundary = next((layers[i].name for i in idxs
                         if dom[i] and layers[i].name != graph.output),
                        None)
        if boundary is None:
            continue
        out.append((labels[key], boundary))
    out.append(("head", graph.output))
    if len(out) < 2:
        raise ValueError(
            "stage tags found but no dominating boundaries; pass explicit "
            "boundaries")
    return out


def serving_boundaries(graph: G.LayerGraph) -> List[Tuple[str, str]]:
    """:func:`auto_boundaries`, with the stem a stage of its own where the
    model has a ``stem_activation`` layer (EfficientNet), as the JAX
    package's ``scripts/serving_attribution.py`` cuts it."""
    boundaries = auto_boundaries(graph)
    if "stem_activation" in graph.layer_names:
        boundaries = [("stem", "stem_activation")] + boundaries
    return boundaries


def stage_segments(spec: ModelSpec,
                   boundaries: Optional[List[Tuple[str, str]]] = None
                   ) -> List[Segment]:
    """``[(label, boundary, prev_boundary, segment graph), ...]``: stage
    ``label`` is the layers after ``prev_boundary`` (None: the model input)
    up to ``boundary``. An explicit boundary that does not dominate the
    graph raises, as in the JAX package."""
    graph = spec.graph
    if boundaries is None:
        boundaries = auto_boundaries(graph)
    else:
        dom = _dominator_indices(graph)
        for _label, b in boundaries:
            if b != graph.output and not dom[graph.index_of(b)]:
                raise ValueError(
                    f"boundary {b!r} does not dominate the graph: a later "
                    f"layer reads an earlier activation across it, so its "
                    f"segment would re-run the prefix; pick a residual "
                    f"join / pooling layer instead")
    segs: List[Segment] = []
    prev = None
    for label, boundary in boundaries:
        segs.append((label, boundary, prev, graph.segment(prev, boundary)))
        prev = boundary
    return segs


def segment_module(graph: G.LayerGraph,
                   state_dict: Dict[str, torch.Tensor], device: torch.device,
                   dtype: torch.dtype) -> G.GraphModule:
    """A segment's module with its layers' entries of the full model's
    ``state_dict``, in eval mode on ``device`` in ``dtype``, channels_last:
    the serving form (``predict.load_module``)."""
    module = G.GraphModule(graph)
    own = {name for name, _ in module.named_children()}
    module.load_state_dict({k: v for k, v in state_dict.items()
                            if k.split(".", 1)[0] in own})
    return module.eval().to(device=device, dtype=dtype,
                            memory_format=torch.channels_last)


def segment_bytes(graph: G.LayerGraph, module: G.GraphModule,
                  shapes: Dict[str, Tuple[int, ...]], prev: Optional[str],
                  batch: int, itemsize: int) -> float:
    """The segment's eager traffic at ``batch`` (see the module docstring):
    each layer's inputs and output at ``itemsize`` bytes, the module's
    parameters and buffers in their own dtype."""
    source = prev or G.INPUT  # what the segment's input node stands for
    acts = 0
    for spec in graph.layers[1:]:
        if spec.kind == G.KIND_DROPOUT:
            continue
        for n in spec.inputs + (spec.name,):
            acts += int(np.prod(shapes[source if n == G.INPUT else n][1:]))
    weights = sum(t.numel() * t.element_size()
                  for t in list(module.parameters()) + list(module.buffers()))
    return float(acts * batch * itemsize + weights)


def _per_run_seconds(replay: Callable[[], None], iters: int,
                     device: torch.device, repeats: int = 2) -> float:
    """One run's seconds: (2L runs - L runs) / L, each the least of
    ``repeats`` measurements (``benchmark.timers``: CUDA events on a GPU,
    the host clock on the CPU), after one warm-up."""
    run_many, _ = timers(replay, device)
    replay()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def best(n):
        return min(run_many(n) for _ in range(repeats))
    return (best(2 * iters) - best(iters)) / iters


def _capture(fn: Callable[[], torch.Tensor], device: torch.device
             ) -> Tuple[Callable[[], None], int]:
    """``fn`` captured as a CUDA graph (after two warm-up calls on a side
    stream, which fill the kernel wrappers' caches); returns ``(replay, B2
    launches one replay makes)``, each replay counted in the kernels'
    launch counts (``ops/launches.py``). On the CPU, ``(fn, 0)``."""
    if device.type != "cuda":
        return fn, 0
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launches.capture() as captured, torch.cuda.graph(graph):
        fn()

    def replay():
        graph.replay()
        captured.replayed()
    return replay, captured.per_replay["depthwise"]


def attribute_stages(spec: ModelSpec,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None, *,
                     batch: int = 512,
                     boundaries: Optional[List[Tuple[str, str]]] = None,
                     iters: int = 16, dtype: Optional[torch.dtype] = None,
                     device=None, verbose: bool = True) -> List[Dict]:
    """Per-stage device time and FLOP / byte counts of ``spec`` at
    ``batch`` on ``device`` (default cuda), in ``dtype`` (default
    bfloat16); weights ``state_dict``, else a seeded Keras-style init.

    One row per stage, with the JAX package's keys: ``stage``,
    ``boundary``, ``ms`` (one execution: the segment's CUDA graph replayed
    L and 2L times, differenced, the null graph's time subtracted),
    ``chain_overhead_share`` (the null graph's time over the segment's,
    clamped to [-1, 1]), ``gflops``, ``tflops_per_sec``, ``gb_accessed``,
    ``gb_per_sec`` and ``flops_per_byte`` (defined in the module
    docstring), unrounded; and ``depthwise_launches``, kernel B2's
    launches in one execution of the segment (recorded at its capture; 0
    on the CPU).

    The first segment is fed zeros, the others standard-normal
    activations scaled by 0.1 of their boundary's shape."""
    device = resolve_device(device)
    dtype = dtype or torch.bfloat16
    if state_dict is None:
        state_dict = seeded_state(spec)
    shapes = spec.layer_shapes(state_dict)
    gen = torch.Generator(device=device).manual_seed(0)
    itemsize = torch.empty((), dtype=dtype).element_size()

    rows = []
    for label, boundary, prev, graph in stage_segments(spec, boundaries):
        module = segment_module(graph, state_dict, device, dtype)
        in_shape = (batch,) + shapes[prev or G.INPUT][1:]
        if prev is None:
            feed = torch.zeros(in_shape, device=device, dtype=dtype)
        else:
            feed = (torch.randn(in_shape, generator=gen, device=device)
                    * 0.1).to(dtype)
        flops = flops_per_frame(module, in_shape[1:], dtype, device) * batch
        hbm = segment_bytes(graph, module, shapes, prev, batch, itemsize)

        with torch.inference_mode():
            replay, dw = _capture(lambda: module(feed), device)
            null, _ = _capture(lambda: feed.view(-1)[:1] * 1, device)
            t_seg = _per_run_seconds(replay, iters, device)
            t_null = _per_run_seconds(null, iters, device)
        t = max(t_seg - t_null, 1e-9)
        rows.append({
            "stage": label, "boundary": boundary,
            "ms": t * 1e3,
            "chain_overhead_share": max(-1.0, min(1.0, t_null
                                                  / max(t_seg, 1e-12))),
            "gflops": flops / 1e9,
            "tflops_per_sec": flops / t / 1e12,
            "gb_accessed": hbm / 1e9,
            "gb_per_sec": hbm / t / 1e9,
            "flops_per_byte": flops / hbm if hbm else None,
            "depthwise_launches": dw,
        })
        del replay, null, module, feed
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if verbose:
            print(f"[stage] {json.dumps(rows[-1])}", flush=True)
    return rows


def main(argv=None) -> int:
    """``python -m ab_line_classifier_torch.predict.attribution --model
    efficientnetb7 --batch 512 [--sweep 512 1024] [--device cpu]``: a
    serving batch sweep (``clip_inference_benchmark``) and the per-stage
    attribution of a mixed-precision zoo model with seeded weights, on
    ``--device`` (default cuda); prints one JSON line. Where the model has a
    ``stem_activation`` layer, the stem is a stage of its own."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--model", default="efficientnetb7")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--img-dim", type=int, nargs=2, default=(128, 128))
    ap.add_argument("--sweep", nargs="*", type=int, default=[])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = build_zoo(args.model, tuple(args.img_dim))
    state = seeded_state(spec)
    sweep = {}
    for b in args.sweep:
        r = clip_inference_benchmark(batch_size=b, spec=spec,
                                     state_dict=state, device=device,
                                     verbose=False)
        sweep[str(b)] = {"frames_per_sec": r["frames_per_sec"],
                         "ms_per_batch": r["ms_per_batch"]}
        print(f"[sweep] batch {b}: {r['frames_per_sec']:.0f} frames/s",
              flush=True)
    rows = attribute_stages(spec, state, batch=args.batch,
                            boundaries=serving_boundaries(spec.graph),
                            iters=args.iters,
                            dtype=spec.dtype, device=device)
    print(json.dumps({
        "model": args.model, "batch": args.batch,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "sweep": sweep,
        "stage_total_ms": sum(r["ms"] for r in rows),
        "stages": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
