"""Frames to model input: nearest resize, then each model's Keras
``preprocess_input`` (``caffe``: RGB to BGR, the ImageNet BGR means
subtracted; ``tf``: scaled to [-1, 1]), float32."""

from __future__ import annotations

import numpy as np
import torch

CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def nearest_indices(src: int, dst: int, mode: str) -> np.ndarray:
    """Source index of each output index of a 1-D nearest resize: ``tf``
    takes the pixel under the output pixel's centre, ``floor((i + 0.5) *
    src / dst)``; ``cv2`` ``floor(i * src / dst)``; float64, clipped."""
    i = np.arange(dst, dtype=np.float64)
    scale = src / dst
    idx = np.floor((i + 0.5) * scale) if mode == "tf" else np.floor(i * scale)
    return np.clip(idx, 0, src - 1).astype(np.int64)


def resize(frames: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> nearest resize to ``out_hw``."""
    rows = torch.as_tensor(nearest_indices(frames.shape[1], out_hw[0], mode),
                           device=frames.device)
    cols = torch.as_tensor(nearest_indices(frames.shape[2], out_hw[1], mode),
                           device=frames.device)
    return frames.index_select(1, rows).index_select(2, cols)


def scale_input(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float RGB in [0, 255], NHWC -> the model's input."""
    x = x.to(torch.float32)
    if mode == "caffe":
        mean = torch.tensor(CAFFE_MEAN_BGR, device=x.device)
        return x.flip(-1) - mean
    if mode == "tf":
        return x / 127.5 - 1.0
    raise ValueError(f"unknown preprocess mode {mode!r}")


def model_input(frames: torch.Tensor, config: dict) -> torch.Tensor:
    """Served uint8 frames -> the model's float32 input."""
    hw = tuple(config["input_shape"][:2])
    return scale_input(resize(frames, hw, config["resize_mode"]),
                       config["preprocess_mode"])
