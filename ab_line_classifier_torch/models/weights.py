"""Keras ``.h5`` weight import and export (port of the JAX package's
``models/weights.py``).

The reference serves and warm-starts from Keras h5 files by name-matched
layer weight copy. Every graph node here carries its Keras layer name, so
the same name matching works. The importer and exporter work on the JAX
package's numpy variable tree ``{params, batch_stats}`` (Keras and flax
share their layouts, so each conversion below is the only one needed):

* Conv2D kernel ``(h, w, in, out)`` and Dense kernel ``(in, out)`` —
  identical layouts, no transpose.
* DepthwiseConv2D ``(h, w, in, 1)`` -> the grouped-conv kernel
  ``(h, w, 1, in)``.
* SeparableConv2D -> the ``depthwise`` / ``pointwise`` submodules.
* BatchNormalization gamma/beta -> scale/bias; moving mean/variance ->
  ``batch_stats``.

:func:`import_h5_state` and :func:`export_h5_state` connect them to the
port's state dicts through the weight bridge (``utils/jax_params.py``),
which owns the tree <-> state-dict transposes. Layers present on only one
side are skipped with a notice, as the reference's try/except copy loop
does; a layer is committed only when every one of its arrays fits.
h5py is imported only by the functions that read or write a file.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ab_line_classifier_torch.graph import KIND_DEPTHWISE
from ab_line_classifier_torch.utils.jax_params import (flax_from_state_dict,
                                                       state_dict_from_flax)


def _h5_layer_names(h5_file) -> List[str]:
    """Top-level layer group names in a name-addressable Keras h5."""
    root = h5_file["model_weights"] if "model_weights" in h5_file else h5_file
    return [k for k in root.keys() if k != "top_level_model_weights"]


def _h5_layer_weights(h5_file, layer_name: str) -> Dict[str, np.ndarray]:
    """Flatten one layer's weight arrays out of a Keras h5 file."""
    import h5py

    root = h5_file["model_weights"] if "model_weights" in h5_file else h5_file
    if layer_name not in root:
        return {}
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name.split("/")[-1].replace(":0", "")] = np.asarray(obj)

    root[layer_name].visititems(visit)
    return out


def _put(d: Dict[str, Any], key: str, arr, ctx: str = "") -> None:
    """Shape-checked assignment into a STAGED layer dict, the one commit
    primitive of both import layouts: a wrong-shape h5 array fails here
    with the layer named, and callers commit the staged dict only after
    every ``_put`` of the layer succeeded, so a failure mid-layer leaves no
    half-imported layer."""
    arr = np.asarray(arr)
    if tuple(np.shape(d[key])) != tuple(arr.shape):
        raise ValueError(
            f"{key} shape mismatch {tuple(np.shape(d[key]))} vs "
            f"{tuple(arr.shape)}" + (f" ({ctx})" if ctx else ""))
    d[key] = arr


def _keras3_class_of(node_kind: str, layer_params) -> str:
    """The keras class prefix Keras 3 uses as the h5 group name."""
    if layer_params is not None and "depthwise" in layer_params:
        return "separable_conv2d"
    return {
        "conv": "conv2d",
        "depthwise": "depthwise_conv2d",
        "bn": "batch_normalization",
        "dense": "dense",
        "norm": "normalization",
    }.get(node_kind, node_kind)


def _import_keras3_h5(f, params, batch_stats, graph, verbose) -> int:
    """Keras 3 ``.weights.h5`` layout: ``layers/<class>[_N]/vars/<i>``,
    named by per-class creation counters rather than layer names. Weighted
    graph nodes map onto the groups by (keras class, creation order), which
    holds because the graph appends nodes in the reference's Keras call
    order. Var order per class follows keras ``layer.weights``."""
    groups: Dict[str, list] = {}
    for gname in f["layers"]:
        cls, _, suffix = gname.rpartition("_")
        if suffix.isdigit() and cls:
            groups.setdefault(cls, []).append((int(suffix), gname))
        else:
            groups.setdefault(gname, []).append((-1, gname))
    for v in groups.values():
        v.sort()
    cursor = {k: 0 for k in groups}

    copied = 0
    for spec in graph.layers:
        name = spec.name
        has_p = name in params
        has_bs = name in batch_stats
        if not (has_p or has_bs):
            continue
        cls = _keras3_class_of(spec.kind, params.get(name))
        if cls not in groups or cursor[cls] >= len(groups[cls]):
            if verbose:
                print(f"{name} ({cls}) is not in the h5 file.")
            continue
        gname = groups[cls][cursor[cls]][1]
        cursor[cls] += 1
        g = f["layers"][gname]["vars"]
        ws = [np.asarray(g[str(i)]) for i in range(len(g))]
        p = params.get(name)

        def put(d, key, arr):
            # Class+order addressing binds the wrong group when the cursor
            # is off, and same-shaped layers (BN in Xception's 728-wide
            # middle flow) would then take wrong weights silently: the
            # shape check is what catches it.
            _put(d, key, arr, ctx=f"h5 group {gname}")

        try:
            new_p = dict(p) if p is not None else None
            new_bs = dict(batch_stats[name]) if has_bs else None
            if cls == "separable_conv2d":
                new_p["depthwise"] = dict(new_p["depthwise"])
                put(new_p["depthwise"], "kernel", ws[0].transpose(0, 1, 3, 2))
                new_p["pointwise"] = dict(new_p["pointwise"])
                put(new_p["pointwise"], "kernel", ws[1])
                if len(ws) > 2 and "bias" in new_p["pointwise"]:
                    put(new_p["pointwise"], "bias", ws[2])
            elif cls == "depthwise_conv2d":
                put(new_p, "kernel", ws[0].transpose(0, 1, 3, 2))
                if len(ws) > 1 and "bias" in new_p:
                    put(new_p, "bias", ws[1])
            elif cls == "batch_normalization":
                i = 0
                if "scale" in new_p:  # keras var order: [gamma] beta mean var
                    put(new_p, "scale", ws[i])
                    i += 1
                put(new_p, "bias", ws[i])
                put(new_bs, "mean", ws[-2])
                put(new_bs, "var", ws[-1])
            elif cls == "normalization":
                put(new_bs, "mean", ws[0].reshape(-1))
                put(new_bs, "variance", ws[1].reshape(-1))
            else:  # conv2d / dense
                put(new_p, "kernel", ws[0])
                if len(ws) > 1 and "bias" in new_p:
                    put(new_p, "bias", ws[1])
            if new_p is not None:
                params[name] = new_p
            if new_bs is not None:
                batch_stats[name] = new_bs
            copied += 1
        except (KeyError, IndexError, TypeError, ValueError) as e:
            if verbose:
                print(f"could not copy {name}: {e}")
    return copied


def import_h5_weights(h5_path: str, variables: Dict[str, Any],
                      verbose: bool = True,
                      graph=None) -> Tuple[Dict[str, Any], int]:
    """Copy weights from a Keras h5 into a numpy variable tree ``{params,
    batch_stats}``. Returns ``(new_variables, n_layers_copied)``.

    Three layouts: the Keras 2.x full-model layout of the reference's
    checkpoints (name-addressable ``model_weights/<layer>/...``); the
    weights-only legacy layout of ``keras.applications`` files (layer
    groups at the file root); and Keras 3 ``.weights.h5`` (addressed by
    class and order, so it needs ``graph`` to recover the layer order)."""
    import h5py

    params = {k: dict(v) for k, v in variables["params"].items()}
    batch_stats = {k: dict(v)
                   for k, v in variables.get("batch_stats", {}).items()}
    copied = 0

    with h5py.File(h5_path, "r") as f:
        if "layers" in f and "model_weights" not in f:
            if graph is None:
                raise ValueError(
                    "this is a Keras 3 .weights.h5 (layer groups are not "
                    "name-addressable); pass graph= to map by layer order")
            copied = _import_keras3_h5(f, params, batch_stats, graph,
                                       verbose)
            return _with(variables, params, batch_stats), copied
        for layer_name in list(params):
            w = _h5_layer_weights(f, layer_name)
            if not w and layer_name == "logits":
                # The reference names its head Dense 'output'
                # (cutoffvgg16, custom_resnetv2) or leaves it Keras-auto-
                # named ('dense', 'dense_1', ... in creation order; the head
                # is created last). Explicit head names first, then the
                # auto-named dense groups in DESCENDING suffix order, so
                # that when a hidden 'dense' and the head 'dense_1' both
                # fit the kernel shape, the head wins.
                auto = sorted(
                    (n for n in _h5_layer_names(f)
                     if re.fullmatch(r"dense(_\d+)?", n)),
                    key=lambda n: int(n.split("_")[1]) if "_" in n else 0,
                    reverse=True)
                for alias in ("output", "logits_dense", *auto):
                    cand = _h5_layer_weights(f, alias)
                    if ("kernel" in cand
                            and cand["kernel"].shape
                            == params[layer_name]["kernel"].shape):
                        w = cand
                        break
            if not w:
                if verbose:
                    print(f"{layer_name} is not in the h5 file.")
                continue

            def put(d, key, arr):
                _put(d, key, arr, ctx=layer_name)

            try:
                new_p = dict(params[layer_name])
                new_bs = (dict(batch_stats[layer_name])
                          if layer_name in batch_stats else None)
                if "depthwise" in new_p:  # SeparableConv2D
                    dw = w["depthwise_kernel"]
                    new_p["depthwise"] = dict(new_p["depthwise"])
                    put(new_p["depthwise"], "kernel",
                        dw.transpose(0, 1, 3, 2))
                    new_p["pointwise"] = dict(new_p["pointwise"])
                    put(new_p["pointwise"], "kernel", w["pointwise_kernel"])
                    if "bias" in w and "bias" in new_p["pointwise"]:
                        put(new_p["pointwise"], "bias", w["bias"])
                elif "depthwise_kernel" in w:  # DepthwiseConv2D
                    put(new_p, "kernel",
                        w["depthwise_kernel"].transpose(0, 1, 3, 2))
                    if "bias" in w and "bias" in new_p:
                        put(new_p, "bias", w["bias"])
                elif "gamma" in w or "beta" in w:  # BatchNormalization
                    if "gamma" in w and "scale" in new_p:
                        put(new_p, "scale", w["gamma"])
                    if "beta" in w and "bias" in new_p:
                        put(new_p, "bias", w["beta"])
                    if new_bs is not None:
                        if "moving_mean" in w:
                            put(new_bs, "mean", w["moving_mean"])
                        if "moving_variance" in w:
                            put(new_bs, "var", w["moving_variance"])
                elif "kernel" in w:  # Conv2D / Dense
                    put(new_p, "kernel", w["kernel"])
                    if "bias" in w and "bias" in new_p:
                        put(new_p, "bias", w["bias"])
                else:
                    raise ValueError(f"unrecognized weight set {list(w)}")
                params[layer_name] = new_p
                if new_bs is not None:
                    batch_stats[layer_name] = new_bs
                copied += 1
            except (KeyError, TypeError, ValueError) as e:
                if verbose:
                    print(f"could not copy {layer_name}: {e}")

        # Stats-only layers (keras Normalization: mean/variance live in
        # batch_stats with no params, e.g. EfficientNet's stem), staged and
        # shape-checked like every other assignment.
        for layer_name in list(batch_stats):
            if layer_name in params:
                continue
            w = _h5_layer_weights(f, layer_name)
            if "mean" in w and "variance" in w:
                try:
                    new_bs = dict(batch_stats[layer_name])
                    _put(new_bs, "mean", w["mean"].reshape(-1),
                         ctx=layer_name)
                    _put(new_bs, "variance", w["variance"].reshape(-1),
                         ctx=layer_name)
                    batch_stats[layer_name] = new_bs
                    copied += 1
                except ValueError as e:
                    if verbose:
                        print(f"could not copy {layer_name}: {e}")

    return _with(variables, params, batch_stats), copied


def _with(variables: Dict[str, Any], params: Dict, batch_stats: Dict
          ) -> Dict[str, Any]:
    out = dict(variables)
    out["params"] = params
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def export_h5_weights(h5_path: str, variables: Dict[str, Any],
                      graph=None) -> None:
    """Write a numpy variable tree to the Keras 2.x h5 layout.

    Keras ``load_weights(by_name=True)`` reads the ``layer_names`` group
    attribute and each layer group's ``weight_names`` attribute (legacy
    hdf5 format), so both are written. ``graph`` tells DepthwiseConv2D
    nodes apart exactly (Keras names their kernel ``depthwise_kernel:0``,
    layout ``(h, w, C, 1)``). Without it the ``(h, w, 1, C)`` kernel shape
    is ambiguous (a plain conv on a one-channel input has it too), so a
    layer counts as depthwise only with the zoo's naming (``*_depthwise`` /
    ``*_dwconv``), and an ambiguous layer named otherwise exports as a
    plain conv, with a warning."""
    import h5py

    kinds = ({spec.name: spec.kind for spec in graph.layers}
             if graph is not None else {})

    def _is_depthwise(layer_name: str, p) -> bool:
        if layer_name in kinds:
            return kinds[layer_name] == KIND_DEPTHWISE
        k = np.asarray(p["kernel"])
        ambiguous = k.ndim == 4 and k.shape[2] == 1 and k.shape[3] > 1
        named = "depthwise" in layer_name or "dwconv" in layer_name
        if ambiguous and not named:
            warnings.warn(
                f"layer {layer_name!r} has the shape-ambiguous (h, w, 1, "
                f"C) kernel but no depthwise naming; exporting as a plain "
                f"conv kernel:0 — pass graph= if it is a DepthwiseConv2D")
        return ambiguous and named

    with h5py.File(h5_path, "w") as f:
        root = f.create_group("model_weights")
        root.attrs["backend"] = np.bytes_(b"tensorflow")
        root.attrs["keras_version"] = np.bytes_(b"2.9.0")
        bs = variables.get("batch_stats", {})
        layer_names = []

        def write_layer(layer_name, weights):
            """One layer group with its Keras ``weight_names`` attr."""
            g = root.create_group(layer_name).create_group(layer_name)
            names = []
            for wname, arr in weights:
                g.create_dataset(wname, data=np.asarray(arr))
                names.append(f"{layer_name}/{wname}".encode())
            root[layer_name].attrs["weight_names"] = names
            layer_names.append(layer_name.encode())

        for layer_name, p in variables["params"].items():
            if "depthwise" in p:  # SeparableConv2D
                ws = [("depthwise_kernel:0",
                       np.asarray(p["depthwise"]["kernel"]).transpose(
                           0, 1, 3, 2)),
                      ("pointwise_kernel:0", p["pointwise"]["kernel"])]
                if "bias" in p["pointwise"]:
                    ws.append(("bias:0", p["pointwise"]["bias"]))
            elif "scale" in p or layer_name in bs:  # BatchNormalization
                ws = []
                if "scale" in p:
                    ws.append(("gamma:0", p["scale"]))
                if "bias" in p:
                    ws.append(("beta:0", p["bias"]))
                if layer_name in bs:
                    ws.append(("moving_mean:0", bs[layer_name]["mean"]))
                    ws.append(("moving_variance:0", bs[layer_name]["var"]))
            elif _is_depthwise(layer_name, p):  # DepthwiseConv2D
                ws = [("depthwise_kernel:0",
                       np.asarray(p["kernel"]).transpose(0, 1, 3, 2))]
                if "bias" in p:
                    ws.append(("bias:0", p["bias"]))
            else:  # Conv2D / Dense
                ws = [("kernel:0", p["kernel"])]
                if "bias" in p:
                    ws.append(("bias:0", p["bias"]))
            write_layer(layer_name, ws)

        # Stats-only layers (keras Normalization) have no params entry;
        # Keras tracks [mean, variance, count], and count (adapt()-time
        # bookkeeping, not carried here) is written as 0 so that by-name
        # loading sees the full weight list.
        for layer_name, stats in bs.items():
            if layer_name in variables["params"] or "variance" not in stats:
                continue
            write_layer(layer_name,
                        [("mean:0", stats["mean"]),
                         ("variance:0", stats["variance"]),
                         ("count:0", np.asarray(0, np.int64))])
        root.attrs["layer_names"] = layer_names


def import_h5_state(h5_path: str, state_dict: Mapping[str, torch.Tensor],
                    graph=None, verbose: bool = True
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
    """:func:`import_h5_weights` on a port state dict (a fresh module's,
    say), through the weight bridge. Returns ``(state_dict,
    n_layers_copied)``; layers the file lacks keep ``state_dict``'s
    values."""
    variables, copied = import_h5_weights(
        h5_path, flax_from_state_dict(state_dict), verbose=verbose,
        graph=graph)
    return state_dict_from_flax(variables), copied


def export_h5_state(h5_path: str, state_dict: Mapping[str, torch.Tensor],
                    graph=None) -> None:
    """:func:`export_h5_weights` of a port state dict (through the weight
    bridge; bfloat16 tensors are written as float32)."""
    export_h5_weights(h5_path, flax_from_state_dict(state_dict), graph=graph)
