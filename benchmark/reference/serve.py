"""The serving forward, plainly: uint8 frames -> resize and scale ->
the model in eval form -> float32 softmax probabilities."""

from __future__ import annotations

import torch

from reference.preprocess import model_input


@torch.no_grad()
def probabilities(model, config: dict, frames: torch.Tensor,
                  block: int = 256):
    """float32 ``[B, n_classes]`` for uint8 ``[B, H, W, 3]`` frames, in
    blocks of ``block`` frames, and each frame's logit scale: the norm of
    the ``logits`` layer's input times the root mean square of its weight
    rows' norms, the size of the terms each logit sums."""
    out, scale = [], []
    rows = model.logits.weight.norm(dim=1).square().mean().sqrt()
    hook = model.logits.register_forward_pre_hook(
        lambda m, args: scale.append(args[0].norm(dim=1) * rows))
    try:
        for i in range(0, frames.shape[0], block):
            logits, _ = model(model_input(frames[i:i + block], config))
            out.append(torch.softmax(logits.to(torch.float32), dim=-1))
    finally:
        hook.remove()
    return torch.cat(out), torch.cat(scale)
