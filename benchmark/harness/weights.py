"""Seeded weights for a configuration, made on the device in one draw:
kernels zero-mean normal with ``kernel_gain / sqrt(fan_in)``, biases and
batch-norm shifts ``N(bias_mean, bias_std)``, batch-norm scales
``N(bn_scale, 0.1)``; batch-norm statistics then set, layer after layer,
from the reference's float32 pass over calibration frames (the mean, and
the variance plus a quarter of the squared mean), so activations neither
vanish nor saturate. The same state dict goes to the program and to the
reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

import reference
from reference.layers import BatchNorm
from reference.preprocess import scale_input

from harness import gen


@torch.no_grad()
def make(model: torch.nn.Module, config: dict, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """float32 state dict (on ``device``) for ``model``, the configuration's
    reference model, whose own values are left as they were."""
    spec = config["weights"]
    state = model.state_dict()
    bn = {n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    drawn = [k for k in state if not k.endswith(("running_mean",
                                                 "running_var"))]
    total = sum(state[k].numel() for k in drawn)
    z = torch.randn(total, generator=gen.generator(seed, "weights", device),
                    device=device)
    out, at = {}, 0
    for k, v in state.items():
        if k not in drawn:
            out[k] = (torch.zeros_like(v) if k.endswith("running_mean")
                      else torch.ones_like(v)).to(device)
            continue
        part = z[at:at + v.numel()].view(v.shape)
        at += v.numel()
        layer, leaf = k.rsplit(".", 1)
        if v.ndim >= 2:
            out[k] = part * (spec["kernel_gain"]
                             / math.sqrt(v[0].numel()))
        elif layer in bn and leaf == "weight":
            out[k] = spec["bn_scale"] + 0.1 * part
        else:
            out[k] = spec["bias_mean"] + spec["bias_std"] * part
    if bn:
        _calibrate(config, out, seed, device)
    return out


def _calibrate(config: dict, state: Dict[str, torch.Tensor], seed: int,
               device) -> None:
    cal = config["weights"]["calibration"]
    model = reference.build(config).to(device)
    model.load_state_dict(state)
    images = gen.frames(gen.generator(seed, "calibration", device),
                        cal["frames"], config["input_shape"][:2],
                        cal["brightness"], device)

    def hook(module, args):
        a = args[0]
        mean = a.mean((0, 2, 3))
        module.running_mean.copy_(mean)
        module.running_var.copy_(a.var((0, 2, 3), unbiased=False)
                                 + 0.25 * mean ** 2)

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with reference.exact_float32():
            model(scale_input(images, config["preprocess_mode"]))
    finally:
        for h in hooks:
            h.remove()
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            state[k] = v.detach().clone()
