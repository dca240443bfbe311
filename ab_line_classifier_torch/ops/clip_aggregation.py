"""Clip-level aggregation of frame predictions, on the device (port of
the JAX package's ``ops/clip_aggregation.py``).

All three algorithms are vectorized over a padded ``[..., T, C]`` batch of
frame probabilities with a ``[..., T]`` frame-validity mask, so a whole
dataset's clips aggregate in a few tensor ops:

* ``average`` — masked mean over frames.
* ``sliding_window`` — max over all length-W windowed means of the B-line
  probability, from a prefix sum.
* ``contiguous`` — longest run of frames whose B-line probability exceeds
  the classification threshold, from a cumsum/cummax run-length identity.

Results are ``[..., C]`` clip probabilities (binary: column 1 is B-lines).
Sums and counts accumulate in float32 whatever the probability dtype. The
sliding window's float32 prefix sum is added in the JAX package's order
(:func:`prefix_sum`), so its clip probabilities are the JAX package's bit
for bit, on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _default_mask(probs: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(probs.shape[:-1], dtype=probs.dtype,
                          device=probs.device)
    return mask.to(probs.dtype)


def average_clip_probs(probs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean over the frame axis; sum and count in float32 (a bf16
    count saturates at 256), cast back to the input dtype."""
    m = _default_mask(probs, mask).to(torch.float32)
    total = (probs.to(torch.float32) * m[..., None]).sum(dim=-2)
    count = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return (total / count).to(probs.dtype)


# XLA (the JAX package's CPU backend) rewrites a cumulative sum into tiles
# of this many elements.
SCAN_TILE = 16


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum over the last axis, added in the order
    XLA's CPU backend adds ``jnp.cumsum``: tiles of 16 each summed left to
    right, the tiles' totals prefix-summed the same way (recursively), and
    each tile's exclusive carry added to its elements. Each step is an
    elementwise add, so every device rounds alike; ``torch.cumsum``'s order
    differs by device and from XLA's."""
    x = x.to(torch.float32)
    t = x.shape[-1]
    if t == 0:
        return x
    n = -(-t // SCAN_TILE)
    tiles = F.pad(x, (0, n * SCAN_TILE - t)).unflatten(-1, (n, SCAN_TILE))
    cols = [tiles[..., 0]]
    for j in range(1, SCAN_TILE):
        cols.append(cols[-1] + tiles[..., j])
    local = torch.stack(cols, dim=-1)
    if n > 1:
        inclusive = prefix_sum(local[..., -1])
        carry = F.pad(inclusive[..., :-1], (1, 0))
        local = local + carry[..., None]
    return local.flatten(-2)[..., :t]


def max_contiguous_positive(preds: torch.Tensor,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Longest run of 1s in a binary ``[..., T]`` sequence.

    With s = cumsum(b) and z_i = max over j <= i with b_j = 0 of s_j (0
    before any zero), the run ending at i is s_i - z_i; the answer is the
    max over i. Padding (mask 0) counts as a run-breaker."""
    b = preds.to(torch.int32)
    if mask is not None:
        b = b * mask.to(torch.int32)
    s = torch.cumsum(b, dim=-1, dtype=torch.int32)
    zero_marks = torch.where(b == 0, s, torch.zeros_like(s))
    z = torch.cummax(zero_marks, dim=-1).values
    return (s - z).max(dim=-1).values


def contiguous_clip_probs(probs: torch.Tensor, contiguity_threshold: int,
                          classification_threshold: float,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Clip is positive iff >= contiguity_threshold consecutive frames have
    B-line probability strictly above the classification threshold; returns
    hard ``[1-p, p]`` pseudo-probabilities."""
    b_preds = probs[..., 1] > classification_threshold
    max_run = max_contiguous_positive(b_preds, mask)
    clip_pred = (max_run >= contiguity_threshold).to(probs.dtype)
    return torch.stack([1.0 - clip_pred, clip_pred], dim=-1)


def sliding_window_clip_probs(probs: torch.Tensor, window: int,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Highest mean B-line probability over any ``window`` consecutive valid
    frames, as ``[1-p, p]``; 0 for a clip shorter than the window. The
    prefix sum accumulates in float32."""
    m = _default_mask(probs, mask)
    b = (probs[..., 1] * m).to(torch.float32)
    T = b.shape[-1]
    if T < window:
        max_b = torch.zeros(probs.shape[:-2], dtype=probs.dtype,
                            device=probs.device)
        return torch.stack([1.0 - max_b, max_b], dim=-1)
    s = F.pad(prefix_sum(b), (1, 0))
    win_means = (s[..., window:] - s[..., :-window]) / float(window)
    # A window is valid only if it lies within the clip's valid frames;
    # validity arithmetic in int32.
    n_valid = m.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    starts = torch.arange(win_means.shape[-1], dtype=torch.int32,
                          device=probs.device)
    valid = (starts + window) <= n_valid
    win_means = torch.where(valid, win_means,
                            torch.full_like(win_means, -float("inf")))
    max_b = win_means.max(dim=-1).values
    max_b = torch.where(torch.isfinite(max_b), max_b,
                        torch.zeros_like(max_b)).to(probs.dtype)
    return torch.stack([1.0 - max_b, max_b], dim=-1)


def aggregate_clips(probs: torch.Tensor, mask: torch.Tensor, *,
                    algorithm: str, classification_threshold: float = 0.5,
                    contiguity_threshold: int = 3,
                    window: int = 4) -> torch.Tensor:
    """Dispatch over the three algorithms."""
    if algorithm == "average":
        return average_clip_probs(probs, mask)
    if algorithm == "contiguous":
        return contiguous_clip_probs(probs, contiguity_threshold,
                                     classification_threshold, mask)
    if algorithm == "sliding_window":
        return sliding_window_clip_probs(probs, window, mask)
    raise ValueError(
        f'Unknown value for "clip_algorithm" argument: {algorithm!r}')
