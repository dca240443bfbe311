"""Synthetic LUS-like dataset generator (port of the JAX package's
``data/synthetic.py``).

Writes the reference's on-disk dataset contract, a frames directory of
JPEGs named ``{clip}_{idx}.jpg`` plus frames and clips CSV tables, from
nothing: the same rows, pixels and bytes as the JAX package's generator for
the same seed. Class-conditional structure (a horizontal bright band for
A-lines, vertical streaks for B-lines) makes the tiny training problem
learnable. The tables are written without pandas (``utils/tables.py``, the
bytes ``DataFrame.to_csv`` writes); PIL, which encodes the JPEGs, is
imported by :func:`generate_dataset`.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ab_line_classifier_torch.utils.tables import write_csv

FRAME_PATH = "Frame Path"


def _frame_image(rng: np.random.RandomState, label: int,
                 hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    img = (rng.rand(h, w) * 60).astype(np.float32)
    # A crude ultrasound-looking sector: darker corners.
    yy, xx = np.mgrid[0:h, 0:w]
    beam = (np.abs(xx - w / 2) < (yy + 6) * (w / (1.6 * h))).astype(np.float32)
    img *= beam
    if label == 0:
        # "A-lines": bright horizontal reverberation bands.
        for y0 in range(h // 5, h, h // 5):
            band = np.exp(-0.5 * ((yy - y0) / 1.5) ** 2) * 160
            img += band * beam
    else:
        # "B-lines": bright vertical comet-tail streaks.
        for x0 in rng.choice(np.arange(w // 4, 3 * w // 4), 3, replace=False):
            streak = np.exp(-0.5 * ((xx - x0) / 1.8) ** 2) * 160
            img += streak * beam * (yy > h // 6)
    img += rng.randn(h, w) * 6
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.stack([img] * 3, axis=-1)


def generate_dataset(root: str, *, n_patients: int = 8,
                     clips_per_patient: int = 2, frames_per_clip: int = 6,
                     hw: Tuple[int, int] = (128, 128), seed: int = 0,
                     frames_csv: str = "frames.csv",
                     clips_csv: str = "clips.csv",
                     frames_dirname: str = "frames"):
    """Write a synthetic dataset under ``root``; returns
    ``(frames_csv_path, clips_csv_path, frames_dir)``."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    frames_dir = os.path.join(root, frames_dirname)
    os.makedirs(frames_dir, exist_ok=True)

    frame_rows = []
    clip_rows = []
    clip_id = 0
    for p in range(n_patients):
        patient = f"pat{p:03d}"
        for c in range(clips_per_patient):
            label = int(rng.rand() < 0.5) if p % 2 == 0 else int(p % 4 > 1)
            clip_name = f"clip{clip_id:04d}"
            for f in range(frames_per_clip):
                fname = f"{clip_name}_{f}.jpg"
                img = _frame_image(rng, label, hw)
                Image.fromarray(img).save(os.path.join(frames_dir, fname),
                                          quality=90)
                frame_rows.append({
                    FRAME_PATH: fname,
                    "patient_id": patient,
                    "Class": label,
                    "Class Name": "a_lines" if label == 0 else "b_lines",
                    "id": clip_id,
                })
            clip_rows.append({"filename": clip_name, "class": label,
                              "patient_id": patient, "id": clip_id,
                              "n_frames": frames_per_clip})
            clip_id += 1

    frames_csv_path = os.path.join(root, frames_csv)
    clips_csv_path = os.path.join(root, clips_csv)
    write_csv(frames_csv_path, frame_rows)
    write_csv(clips_csv_path, clip_rows)
    return frames_csv_path, clips_csv_path, frames_dir
