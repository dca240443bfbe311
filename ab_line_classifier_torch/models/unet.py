"""U-Net for ultrasound-beam segmentation, the auto-masking model (port
of the JAX package's ``models/unet.py``).

A 4-level encoder/decoder with skip connections maps a 128x128 grayscale
frame to a sigmoid beam-probability mask. Its layers carry the flax
module's names (``enc0_conv1`` ... ``dec0_conv2``, ``head``), so the weight
bridge (``utils/jax_params.py``) and the ``.h5`` importer below map
weights by name and position. The public forward keeps the JAX layout:
NHWC ``[B, H, W, 1]`` in and out.

The pretrained ``.h5`` the reference loads is not in the repository; the
tests and ``chip_smoke.py`` use random weights from a numpy seed
(:func:`seeded_unet_state`) or an ``.h5`` they write themselves.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F


class UNet(nn.Module):
    """4-level U-Net: ``[B, 128, 128, 1]`` -> ``[B, 128, 128, 1]`` sigmoid
    beam mask. Convolutions are 3x3 ``SAME``; each decoder level upsamples
    with a 2x2 stride-2 transposed convolution (Keras ``Conv2DTranspose``
    semantics, the gradient of a convolution) and concatenates the
    upsampled map before its skip."""

    def __init__(self, base_filters: int = 16, levels: int = 4):
        super().__init__()
        self.base_filters = base_filters
        self.levels = levels
        cin = 1
        for level in range(levels):
            f = base_filters * 2 ** level
            self.add_module(f"enc{level}_conv1", nn.Conv2d(cin, f, 3,
                                                           padding=1))
            self.add_module(f"enc{level}_conv2", nn.Conv2d(f, f, 3,
                                                           padding=1))
            cin = f
        f = base_filters * 2 ** levels
        self.bottleneck_conv1 = nn.Conv2d(cin, f, 3, padding=1)
        self.bottleneck_conv2 = nn.Conv2d(f, f, 3, padding=1)
        cin = f
        for level in reversed(range(levels)):
            f = base_filters * 2 ** level
            self.add_module(f"dec{level}_up",
                            nn.ConvTranspose2d(cin, f, 2, stride=2))
            self.add_module(f"dec{level}_conv1", nn.Conv2d(2 * f, f, 3,
                                                           padding=1))
            self.add_module(f"dec{level}_conv2", nn.Conv2d(f, f, 3,
                                                           padding=1))
            cin = f
        self.head = nn.Conv2d(cin, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        skips = []
        for level in range(self.levels):
            x = F.relu(getattr(self, f"enc{level}_conv1")(x))
            x = F.relu(getattr(self, f"enc{level}_conv2")(x))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = F.relu(self.bottleneck_conv1(x))
        x = F.relu(self.bottleneck_conv2(x))
        for level in reversed(range(self.levels)):
            x = getattr(self, f"dec{level}_up")(x)
            x = torch.cat([x, skips[level]], dim=1)
            x = F.relu(getattr(self, f"dec{level}_conv1")(x))
            x = F.relu(getattr(self, f"dec{level}_conv2")(x))
        x = torch.sigmoid(self.head(x).to(torch.float32))
        return x.permute(0, 2, 3, 1)


def unet_layer_order(levels: int = 4) -> List[str]:
    """Weighted-layer names in module (= topological) order."""
    names = []
    for lv in range(levels):
        names += [f"enc{lv}_conv1", f"enc{lv}_conv2"]
    names += ["bottleneck_conv1", "bottleneck_conv2"]
    for lv in reversed(range(levels)):
        names += [f"dec{lv}_up", f"dec{lv}_conv1", f"dec{lv}_conv2"]
    names.append("head")
    return names


def seeded_unet_state(base_filters: int = 16, seed: int = 0,
                      levels: int = 4) -> Dict[str, torch.Tensor]:
    """Random :class:`UNet` weights from a numpy seed: He-normal kernels
    and small random biases, drawn in :func:`unet_layer_order`."""
    rng = np.random.default_rng(seed)
    state = UNet(base_filters, levels).state_dict()
    out = {}
    for name in unet_layer_order(levels):
        w = state[f"{name}.weight"]
        # A transposed conv's weight is (in, out, kh, kw).
        fan_in = w.shape[0 if name.endswith("_up") else 1] * w[0, 0].numel()
        out[f"{name}.weight"] = torch.as_tensor(rng.normal(
            0.0, np.sqrt(2.0 / fan_in), tuple(w.shape)).astype(np.float32))
        out[f"{name}.bias"] = torch.as_tensor(rng.normal(
            0.0, 0.05, tuple(state[f"{name}.bias"].shape)).astype(np.float32))
    return out


def import_h5_unet_weights(path: str, state_dict: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Load a Keras U-Net ``.h5`` onto a :class:`UNet` state dict (JAX
    ``models/unet.py:92-148``): weights matched by POSITION over the
    file's weighted layers in Keras storage order (the reference's file
    names are not knowable), with strict shape checks; a transposed-conv
    kernel stored ``(in, out)`` instead of Keras's ``(out, in)`` is
    swapped. A U-Net of another width or depth raises, so a clip is never
    masked with weights that silently failed to load. h5py is imported
    here only."""
    import h5py

    levels = sum(1 for k in state_dict if k.startswith("enc")
                 and k.endswith("_conv1.weight"))
    order = unet_layer_order(levels)

    def _dec(s):
        return s.decode() if isinstance(s, bytes) else s

    weighted = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        layer_names = [_dec(n) for n in
                       g.attrs.get("layer_names", list(g.keys()))]
        for ln in layer_names:
            names = [_dec(n) for n in g[ln].attrs.get("weight_names", [])]
            arrs = [np.asarray(g[ln][n]) for n in names]
            if arrs:
                weighted.append((ln, arrs))
    if len(weighted) != len(order):
        raise ValueError(
            f"{path!r} has {len(weighted)} weighted layers; this UNet has "
            f"{len(order)} — not a compatible U-Net architecture")
    new = dict(state_dict)
    for (ln, arrs), ours in zip(weighted, order):
        kern, rest = arrs[0], arrs[1:]
        # A conv's (out, in, kh, kw) and a transposed conv's (in, out, kh,
        # kw) both permute (2, 3, 1, 0) to the Keras layout.
        want = tuple(state_dict[f"{ours}.weight"].permute(2, 3, 1, 0).shape)
        if tuple(kern.shape) == want:
            pass
        elif (kern.ndim == 4
              and tuple(kern.transpose(0, 1, 3, 2).shape) == want):
            kern = kern.transpose(0, 1, 3, 2)
        else:
            raise ValueError(f"layer {ln!r} -> {ours!r}: kernel shape "
                             f"{kern.shape} does not map to {want}")
        new[f"{ours}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
        bias = state_dict[f"{ours}.bias"]
        if rest:
            if tuple(rest[0].shape) != tuple(bias.shape):
                raise ValueError(f"layer {ln!r} -> {ours!r}: bias shape "
                                 f"{rest[0].shape} != {tuple(bias.shape)}")
            new[f"{ours}.bias"] = torch.from_numpy(np.array(rest[0]))
    return new
