"""The one traffic generator: frames, labels and orders made on the device
from the run's seed and a traffic mix's parameters. The same seed gives the
same inputs; every seed gives the same sizes."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# Streams drawn from one run seed, one generator each.
STREAMS = {"weights": 1, "frames": 2, "labels": 3, "calibration": 4,
           "trainer": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run ``seed``."""
    word = np.random.SeedSequence([int(seed), STREAMS[stream]]
                                  ).generate_state(1, np.uint64)[0]
    return int(word) >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def frames(gen: torch.Generator, n: int, hw, brightness, device,
           block: int = 256) -> torch.Tensor:
    """uint8 ``[n, H, W, 3]``: uniform noise scaled by a per-frame
    brightness drawn uniformly in ``brightness`` (low, high), made in
    blocks of frames to bound the temporaries."""
    h, w = hw
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    lo, hi = brightness
    for i in range(0, n, block):
        k = min(block, n - i)
        noise = torch.randint(0, 256, (k, h, w, 3), generator=gen,
                              device=device, dtype=torch.uint8)
        gain = lo + (hi - lo) * torch.rand((k, 1, 1, 1), generator=gen,
                                           device=device)
        out[i:i + k] = (noise.to(torch.float16) * gain.to(torch.float16)
                        ).to(torch.uint8)
    return out


def serve_pool(seed: int, traffic: dict, device) -> List[torch.Tensor]:
    """``pool_chunks`` distinct chunks of ``chunk`` frames at
    ``frame_hw``."""
    gen = generator(seed, "frames", device)
    return [frames(gen, traffic["chunk"], traffic["frame_hw"],
                   traffic["brightness"], device)
            for _ in range(traffic["pool_chunks"])]


def labels(gen: torch.Generator, n: int, positive: float,
           device) -> torch.Tensor:
    """int64 ``[n]``: class 1 with probability ``positive``."""
    return (torch.rand((n,), generator=gen, device=device)
            < positive).to(torch.int64)


def val_frames(traffic: dict) -> int:
    """A fold's validation frames beside its ``train_frames``: the project
    splits the folds it trains on by ``val_split``
    (``K_FOLD_VALIDATION_SPLIT``), so ``val_split / (1 - val_split)`` of
    the training frames, rounded."""
    s = traffic["val_split"]
    return round(traffic["train_frames"] * s / (1.0 - s))


def fit_sets(seed: int, traffic: dict, device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Training frames and labels, validation frames and labels."""
    g_frames = generator(seed, "frames", device)
    g_labels = generator(seed, "labels", device)
    hw, bright = traffic["frame_hw"], traffic["brightness"]
    n_train, n_val = traffic["train_frames"], val_frames(traffic)
    pos = traffic["positive_share"]
    return (frames(g_frames, n_train, hw, bright, device),
            labels(g_labels, n_train, pos, device),
            frames(g_frames, n_val, hw, bright, device),
            labels(g_labels, n_val, pos, device))
