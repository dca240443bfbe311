"""ONNX checkpoint weight import (port of the JAX package's
``models/onnx_weights.py``).

The reference serves ``.onnx`` checkpoints through an ONNX runtime. Here,
as in the JAX package, restore is a runtime-free *weight importer*: read
the initializers straight from the protobuf (``utils/onnx_proto.py``),
recover each initializer's role from the node that consumes it, and map it
onto the graph's Keras layer names as the ``.h5`` importer does
(``models/weights.py``). The restored model then serves on the port's own
path. Like the h5 importer it works on the JAX package's numpy variable
tree; :func:`import_onnx_state` connects it to a port state dict through
the weight bridge (``utils/jax_params.py``).

Three mapping strategies; 1 and 2 are tried in order, 3 supplements either:

1. **Name-based** — exporters that keep Keras layer names in node and
   initializer paths (tf2onnx emits e.g.
   ``StatefulPartitionedCall/model/block1_conv1/Conv2D/ReadVariableOp:0``);
   a layer binds to the weighted node whose path segments contain its name.
2. **Positional by kind** — per-op-class creation-order matching (the
   Keras 3 h5 importer's scheme): the graph appends nodes in the
   reference's Keras call order, which is the ONNX topological order for
   these chain models.
3. **Semantic-initializer fill** — layers the node strategies could not
   bind are restored straight from initializers named
   ``model/<layer>/<leaf>:0``. Exporters (the JAX package's among them) may
   decompose BatchNorm / Normalization into plain Sub/Mul/Add arithmetic
   over reshaped anonymous constants, so no ``BatchNormalization`` node
   exists to read, while the named parameter initializers are still there.

If any weighted layer still cannot be restored, a ``UserWarning`` lists it
(a silently partial import would serve wrong predictions).

Layout conversions (ONNX -> the variable tree):

* Conv ``(O, I, kH, kW)`` -> ``(kH, kW, I, O)``
* depthwise Conv (``group=C``) ``(C, 1, kH, kW)`` -> ``(kH, kW, 1, C)``
* Gemm ``transB=1`` kernels ``(out, in)`` -> ``(in, out)``; MatMul direct
* BatchNormalization inputs 1..4 are positionally scale/bias/mean/var

Shape-verified: a kernel already stored in the target layout (some
exporters fold the NHWC transpose into the initializer) is accepted as-is.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch.utils import onnx_proto as OP
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)


#: Shape-only unary ops a bias initializer may pass through between its
#: declaration and the Add that applies it (the JAX package's exporter emits
#: ``Reshape(bias) -> Add``; tf2onnx variants use Unsqueeze/Identity).
_SHAPE_ONLY_OPS = {"Reshape", "Identity", "Unsqueeze", "Squeeze", "Flatten"}


def _resolve_initializer(name: str, inits: Dict[str, np.ndarray],
                         producers: Dict[str, Any], hops: int = 4
                         ) -> Optional[Tuple[str, np.ndarray]]:
    """Follow ``name`` backwards through shape-only unary ops to a named
    initializer; returns ``(initializer_name, array)`` or None."""
    for _ in range(hops + 1):
        if name in inits:
            return name, inits[name]
        node = producers.get(name)
        if node is None or node.op_type not in _SHAPE_ONLY_OPS \
                or not node.input:
            return None
        name = node.input[0]
    return None


def _weighted_entries(gp) -> List[Dict[str, Any]]:
    """Ordered (kind, weights, names) entries for every weighted ONNX node.

    Kinds: ``conv`` / ``depthwise`` / ``dense`` / ``bn``. A MatMul whose
    output feeds an Add with a constant operand is fused into one ``dense``
    entry (the tf2onnx Dense pattern).
    """
    inits = OP.initializer_arrays(gp)
    producers = {out: node for node in gp.node for out in node.output}
    entries: List[Dict[str, Any]] = []
    consumed_bias_adds = set()

    for i, node in enumerate(gp.node):
        op = node.op_type
        # Names that identify the layer OWNING this node: the node's own
        # name and its weight-initializer inputs. The DATA input
        # (input[0]) is excluded — in real tf2onnx exports its tensor name
        # carries the UPSTREAM layer's path (e.g. conv2's input is
        # '.../conv1/Relu:0'), and including it would bind every entry to
        # its producer layer in graph order, leaving the consumer layer
        # unrestored (pinned in the tests).
        names = [node.name] + list(node.input[1:])
        if op == "Conv" and len(node.input) > 1 and node.input[1] in inits:
            w = inits[node.input[1]]
            attrs = OP.node_attrs(node)
            group = int(attrs.get("group", 1))
            kind = "depthwise" if group > 1 and w.ndim == 4 \
                and w.shape[1] == 1 else "conv"
            weights = {"kernel": w}
            if len(node.input) > 2 and node.input[2] in inits:
                weights["bias"] = inits[node.input[2]]
            else:
                # Unfused conv bias: follow the output through layout
                # Transposes to an Add with a constant operand (exporters,
                # the JAX package's among them, often emit Conv + Transpose
                # + Add(bias)).
                # The scan STOPS at the first non-Transpose consumer, so a
                # channelwise Add only counts as the bias when it applies
                # DIRECTLY to the conv output — a decomposed BatchNorm
                # (Conv -> Mul(scale) -> Add(beta), or Sub(mean) first)
                # breaks at the Mul/Sub and is never misattributed
                # (pinned in the tests).
                cur = node.output[0] if node.output else None
                for j in range(i + 1, min(i + 6, len(gp.node))):
                    nxt = gp.node[j]
                    if cur not in nxt.input:
                        continue
                    if nxt.op_type == "Transpose":
                        cur = nxt.output[0]
                        continue
                    if nxt.op_type == "Add":
                        for cand in nxt.input:
                            if cand == cur:
                                continue
                            hit = _resolve_initializer(cand, inits, producers)
                            if hit is not None \
                                    and hit[1].size == w.shape[0]:
                                weights["bias"] = hit[1].reshape(-1)
                                names += [nxt.name, hit[0]]
                                break
                    break
            entries.append({"kind": kind, "weights": weights, "names": names})
        elif op == "Gemm" and len(node.input) > 1 and node.input[1] in inits:
            w = inits[node.input[1]]
            if int(OP.node_attrs(node).get("transB", 0)):
                w = w.T
            weights = {"kernel": w}
            if len(node.input) > 2 and node.input[2] in inits:
                weights["bias"] = inits[node.input[2]]
            entries.append({"kind": "dense", "weights": weights,
                            "names": names})
        elif op == "MatMul" and len(node.input) > 1 \
                and node.input[1] in inits:
            weights = {"kernel": inits[node.input[1]]}
            out = node.output[0] if node.output else None
            n_out = weights["kernel"].shape[-1] if \
                weights["kernel"].ndim == 2 else weights["kernel"].size
            for j in range(i + 1, min(i + 5, len(gp.node))):
                nxt = gp.node[j]
                if nxt.op_type == "Add" and out in nxt.input \
                        and j not in consumed_bias_adds:
                    for cand in nxt.input:
                        if cand == out:
                            continue
                        hit = _resolve_initializer(cand, inits, producers)
                        if hit is not None and hit[1].size in (
                                n_out, weights["kernel"].shape[0]):
                            weights["bias"] = hit[1].reshape(-1)
                            names += [nxt.name, hit[0]]
                            consumed_bias_adds.add(j)
                            break
                    break
            entries.append({"kind": "dense", "weights": weights,
                            "names": names})
        elif op == "BatchNormalization" and len(node.input) >= 5:
            roles = ("scale", "bias", "mean", "var")
            weights = {r: inits[n] for r, n in zip(roles, node.input[1:5])
                       if n in inits}
            if len(weights) == 4:
                entries.append({"kind": "bn", "weights": weights,
                                "names": names})
    return entries


def _path_segments(name: str) -> List[str]:
    return [seg.split(":")[0] for seg in name.split("/") if seg]


def _entry_matches_layer(entry: Dict[str, Any], layer_name: str) -> bool:
    for name in entry["names"]:
        if layer_name in _path_segments(name):
            return True
    return False


def _fit_conv_kernel(w: np.ndarray, want: Tuple[int, ...]) -> np.ndarray:
    """ONNX ``(O, I|1, kH, kW)`` -> Flax ``(kH, kW, I|1, O)``; fall back to
    accepting kernels already in the target HWIO layout (non-conformant
    exporters). The OIHW interpretation is deliberately tried FIRST: the
    ONNX spec mandates OIHW for Conv weights, so when a kernel's shape is
    symmetric under both readings (requires O==I==kH==kW — absent from real
    CNNs) the spec-conformant layout wins."""
    if w.ndim == 4 and w.transpose(2, 3, 1, 0).shape == tuple(want):
        return w.transpose(2, 3, 1, 0)
    if w.shape == tuple(want):
        return w
    raise ValueError(f"conv kernel shape {w.shape} does not map to {want}")


def _fit_dense_kernel(w: np.ndarray, want: Tuple[int, ...]) -> np.ndarray:
    if w.shape == tuple(want):
        return w
    if w.ndim == 2 and w.T.shape == tuple(want):
        return w.T
    raise ValueError(f"dense kernel shape {w.shape} does not map to {want}")


def _apply_entry(entry: Dict[str, Any], name: str, p: Optional[Dict],
                 batch_stats: Dict[str, Dict],
                 pointwise: Optional[Dict[str, Any]] = None) -> None:
    w = entry["weights"]
    kind = entry["kind"]
    if kind == "bn":
        # Read every leaf before mutating (all-or-nothing, as below): a
        # KeyError on e.g. a missing running stat must not leave a
        # half-imported scale/bias pair behind.
        staged = [(p, k, w[k]) for k in ("scale", "bias") if k in p]
        if name in batch_stats:
            staged += [(batch_stats[name], "mean", w["mean"]),
                       (batch_stats[name], "var", w["var"])]
        for target, key, value in staged:
            target[key] = value
        return
    if pointwise is not None:  # separable: entry=depthwise, pointwise=conv
        # Fit EVERY leaf before mutating anything: a failure mid-way (a
        # missing pointwise bias, an unmappable kernel shape) must leave the
        # whole layer on its fresh-init values — the partial-import warning
        # promises exactly that, and a half-imported separable (real kernels
        # + zero bias) would serve silently-wrong predictions.
        pw = pointwise["weights"]
        dw_kernel = _fit_conv_kernel(w["kernel"],
                                     np.shape(p["depthwise"]["kernel"]))
        pw_kernel = _fit_conv_kernel(pw["kernel"],
                                     np.shape(p["pointwise"]["kernel"]))
        pw_bias = None
        if "bias" in p["pointwise"]:
            if "bias" not in pw:
                raise ValueError(
                    "pointwise conv expects a bias but the onnx entry "
                    "carries none")
            pw_bias = pw["bias"].reshape(np.shape(p["pointwise"]["bias"]))
        p["depthwise"] = dict(p["depthwise"], kernel=dw_kernel)
        p["pointwise"] = dict(p["pointwise"], kernel=pw_kernel)
        if pw_bias is not None:
            p["pointwise"]["bias"] = pw_bias
        return
    # A biased layer whose entry carries no bias must NOT count as
    # restored: leaving the zero init silently serves wrong predictions
    # (the caller falls back to the named-initializer fill, then warns
    # loudly if that also misses). Checked BEFORE the kernel assignment so
    # a failed layer is left untouched — matching the partial-import
    # warning's "those layers keep their fresh-init values".
    if "bias" in p and "bias" not in w:
        raise ValueError(
            "layer expects a bias but the onnx entry carries none")
    if kind == "dense":
        kernel = _fit_dense_kernel(w["kernel"], np.shape(p["kernel"]))
    else:  # conv / depthwise
        kernel = _fit_conv_kernel(w["kernel"], np.shape(p["kernel"]))
    # Reshape the bias BEFORE assigning the kernel for the same
    # all-or-nothing reason as the separable branch above.
    bias = (w["bias"].reshape(np.shape(p["bias"]))
            if "bias" in p else None)
    p["kernel"] = kernel
    if bias is not None:
        p["bias"] = bias


def _layer_kind_class(layer_params: Optional[Dict], spec_kind: str) -> str:
    """The ONNX entry kind class an IR layer consumes positionally."""
    if layer_params is not None and "depthwise" in layer_params:
        return "separable"
    return {"conv": "conv", "depthwise": "depthwise", "dense": "dense",
            "bn": "bn"}.get(spec_kind, spec_kind)


def import_onnx_weights(onnx_path: str, variables: Dict[str, Any],
                        graph=None, verbose: bool = True
                        ) -> Tuple[Dict[str, Any], int]:
    """Copy weights from a ``.onnx`` file into a variables pytree
    ``{params, batch_stats}``. Returns (new_variables, n_layers_copied).

    ``graph`` (the model's LayerGraph) enables the positional fallback for
    exporters that do not preserve layer names; name-based matching needs
    only ``variables``.
    """
    model = OP.load_model(onnx_path)
    entries = _weighted_entries(model.graph)

    params = {k: dict(v) for k, v in variables["params"].items()}
    batch_stats = {k: dict(v)
                   for k, v in variables.get("batch_stats", {}).items()}

    # Weighted IR layers in graph order (or params order without a graph).
    if graph is not None:
        order = [(s.name, s.kind) for s in graph.layers
                 if s.name in params or s.name in batch_stats]
    else:
        order = [(n, None) for n in params]

    # Strategy 1: name-based binding.
    by_layer: Dict[str, List[Dict[str, Any]]] = {}
    bound = set()
    for e_idx, entry in enumerate(entries):
        for name, _ in order:
            if _entry_matches_layer(entry, name):
                by_layer.setdefault(name, []).append(entry)
                bound.add(e_idx)
                break
    name_based = len(bound) == len(entries) and len(by_layer) > 0

    done = set()
    failures: Dict[str, str] = {}
    if name_based:
        for name, layer_entries in by_layer.items():
            p = params.get(name)
            try:
                if p is not None and "depthwise" in p:
                    dw = [e for e in layer_entries
                          if e["kind"] == "depthwise"]
                    pw = [e for e in layer_entries if e["kind"] == "conv"]
                    if not (dw and pw):
                        raise ValueError("separable layer needs a depthwise "
                                         "+ pointwise conv pair")
                    _apply_entry(dw[0], name, p, batch_stats,
                                 pointwise=pw[0])
                else:
                    _apply_entry(layer_entries[0], name,
                                 p if p is not None else {}, batch_stats)
                done.add(name)
            except Exception as e:
                failures[name] = str(e)
    else:
        if graph is None:
            raise ValueError(
                "this .onnx does not preserve layer names; pass graph= to "
                "map weights by per-kind creation order")
        # Strategy 2: per-kind queues in creation order (the Keras-3 h5
        # importer's scheme, models/weights.py:_import_keras3_h5).
        queues: Dict[str, List[Dict[str, Any]]] = {}
        for entry in entries:
            queues.setdefault(entry["kind"], []).append(entry)
        cursor = {k: 0 for k in queues}

        def take(kind: str) -> Optional[Dict[str, Any]]:
            q = queues.get(kind, [])
            if cursor.get(kind, 0) >= len(q):
                return None
            entry = q[cursor[kind]]
            cursor[kind] += 1
            return entry

        for name, spec_kind in order:
            p = params.get(name)
            kind_class = _layer_kind_class(p, spec_kind)
            try:
                if kind_class == "separable":
                    dw, pw = take("depthwise"), take("conv")
                    if dw is None or pw is None:
                        raise ValueError("onnx graph exhausted")
                    _apply_entry(dw, name, p, batch_stats, pointwise=pw)
                elif kind_class in ("conv", "depthwise", "dense", "bn"):
                    entry = take(kind_class)
                    if entry is None:
                        if verbose:
                            print(f"{name} is not in the onnx file.")
                        continue
                    _apply_entry(entry, name,
                                 p if p is not None else {}, batch_stats)
                else:  # stats-only Normalization etc.: folded by exporters
                    continue
                done.add(name)
            except Exception as e:
                failures[name] = str(e)

    # Strategy 3: semantic-initializer fill for whatever the node-based
    # strategies missed (BatchNorm / Normalization decomposed into anonymous
    # arithmetic — the JAX package's exporter keeps every parameter leaf as
    # a named 'model/<layer>/<leaf>:0' initializer even when nothing
    # consumes it).
    missing = [name for name, _ in order if name not in done]
    if missing:
        done |= _fill_from_named_initializers(
            OP.initializer_arrays(model.graph), missing, params, batch_stats)

    missing = [name for name, _ in order if name not in done]
    if verbose:
        for name in missing:
            if name in failures:
                print(f"could not copy {name}: {failures[name]}")
    if missing:
        warnings.warn(
            f"partial ONNX import from {onnx_path!r}: "
            f"{len(missing)}/{len(order)} weighted layers not found "
            f"({', '.join(missing[:8])}{'...' if len(missing) > 8 else ''}) "
            f"— those layers keep their fresh-init values and predictions "
            f"will be wrong", stacklevel=2)

    out = dict(variables)
    out["params"] = params
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out, len(done)


def _fill_from_named_initializers(inits: Dict[str, np.ndarray],
                                  layer_names: List[str],
                                  params: Dict[str, Dict],
                                  batch_stats: Dict[str, Dict]) -> set:
    """Restore layers directly from ``model/<layer>/<leaf>:0`` initializers
    (strategy 3). A layer counts as restored only when EVERY one of its
    leaves is found with a compatible shape — a half-filled layer is as
    wrong as an untouched one."""
    sem: Dict[Tuple[str, ...], np.ndarray] = {}
    for iname, arr in inits.items():
        segs = _path_segments(iname)
        if len(segs) >= 3 and segs[0] == "model":
            sem[tuple(segs[1:])] = arr

    def fit(arr: np.ndarray, want: Tuple[int, ...]) -> np.ndarray:
        if arr.shape == tuple(want):
            return arr
        if arr.ndim == 4:  # conv kernels may be stored OIHW (exporter-folded)
            return _fit_conv_kernel(arr, want)
        if arr.ndim == 2:
            return _fit_dense_kernel(arr, want)
        return arr.reshape(want)  # 1-D vectors reshaped through singletons

    filled = set()
    for name in layer_names:
        updates: List[Tuple[Dict, str, np.ndarray]] = []

        def collect(tree: Dict, prefix: Tuple[str, ...]) -> bool:
            for leaf, val in tree.items():
                if isinstance(val, dict):
                    if not collect(val, prefix + (leaf,)):
                        return False
                    continue
                arr = sem.get(prefix + (leaf,))
                if arr is None:
                    return False
                try:
                    updates.append((tree, leaf, fit(arr, np.shape(val))))
                except Exception:
                    return False
            return True

        def deep(d):
            return {k: deep(v) if isinstance(v, dict) else v
                    for k, v in d.items()}

        ok = True
        if name in params:
            params[name] = deep(params[name])
            ok = collect(params[name], (name,))
        if ok and name in batch_stats:
            batch_stats[name] = deep(batch_stats[name])
            ok = collect(batch_stats[name], (name,))
        if ok and updates:
            for tree, leaf, arr in updates:
                tree[leaf] = arr
            filled.add(name)
    return filled


def import_onnx_state(onnx_path: str, state_dict: Mapping[str, torch.Tensor],
                      graph=None, verbose: bool = True
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
    """:func:`import_onnx_weights` on a port state dict (a fresh module's,
    say), through the weight bridge. Returns ``(state_dict,
    n_layers_copied)``."""
    variables, copied = import_onnx_weights(
        onnx_path, flax_from_state_dict(state_dict), graph=graph,
        verbose=verbose)
    return state_dict_from_flax(variables), copied
