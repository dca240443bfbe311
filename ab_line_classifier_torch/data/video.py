"""Shared mp4 frame decomposition (port of the JAX package's
``data/video.py``): the clip -> frames loop of the reference's dataset
creators. cv2 is imported by the function."""

from __future__ import annotations

import os
from typing import List


def mp4_to_frames(frames_dir: str, mp4_path: str) -> List[str]:
    """Decompose a clip into ``{clip}_{idx}.jpg`` files under
    ``frames_dir``; returns the relative frame filenames in order."""
    import cv2

    mp4_filename = os.path.split(mp4_path)[1].split(".")[0]
    os.makedirs(frames_dir, exist_ok=True)
    vc = cv2.VideoCapture(mp4_path)
    idx = 0
    image_paths: List[str] = []
    while True:
        ret, frame = vc.read()
        if not ret:
            break
        image_path = f"{mp4_filename}_{idx}.jpg"
        image_paths.append(image_path)
        cv2.imwrite(os.path.join(frames_dir, image_path), frame)
        idx += 1
    vc.release()
    return image_paths
