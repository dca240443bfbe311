"""Figures (the part of the JAX package's ``viz/visualization.py`` that the
port's paths use so far): the Grad-CAM heatmap panel, written as a PNG
under ``PATHS.HEATMAPS`` with the reference's file contract.

matplotlib is imported by the function that draws, with the ``Agg``
backend, so the package imports where matplotlib is not installed.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np


def _ts() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def visualize_heatmap(orig_img: np.ndarray, heatmap_img: np.ndarray,
                      img_filename: str, label: int, probs: np.ndarray,
                      class_names: Sequence[str],
                      dir_path: Optional[str] = None):
    """Side-by-side original / Grad-CAM panel with the true and predicted
    class in the title; saved as ``heatmap_<frame>_<timestamp>.png`` in
    ``dir_path`` (and the figure closed) when ``dir_path`` is given.
    Returns the matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(orig_img.astype(np.uint8))
    axes[0].set_title("Original")
    axes[1].imshow(heatmap_img.astype(np.uint8))
    axes[1].set_title("Grad-CAM")
    for ax in axes:
        ax.axis("off")
    pred_idx = int(np.argmax(probs))
    fig.suptitle(
        f"{os.path.basename(img_filename)}  |  true: {class_names[label]}  "
        f"pred: {class_names[pred_idx]} "
        f"(p={float(np.max(probs)):.3f})")
    fig.tight_layout()
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
        base = os.path.splitext(os.path.basename(img_filename))[0]
        fig.savefig(os.path.join(dir_path, f"heatmap_{base}_{_ts()}.png"),
                    dpi=120)
        plt.close(fig)
    return fig
