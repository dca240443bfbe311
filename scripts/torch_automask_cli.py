#!/usr/bin/env python3
"""Wall time of the PyTorch port's auto-mask CLI
(``UnetSegmentation.predict``) on one NVIDIA GPU, graphed against eager.

N fan clips of H x W (``chip_smoke.beam_frames``) are written with cv2, 20
frames each, so every clip samples every 2nd frame: 10 frames, one
program. A width-16 U-Net with random weights from a numpy seed masks
them (jpg out). The eager chain first runs twice on one clip's sample,
untimed, so no run carries the process's first cuDNN calls. The runs go
graphed, eager, eager, graphed, each with a new segmentation; an eager run
calls ``UnetSegmentation.eager`` where a graphed one calls ``clip_mask``.
Each run prints the wall seconds a clip, each mask call's host
milliseconds (after ``synchronize``: the first, the second and the median
of the rest), the wall a clip left to cv2's decode and writes, and the
share of mask calls that replayed a graph, on the card named by
``nvidia-smi``. Run from the root of a checkout::

    python3 scripts/torch_automask_cli.py [N_CLIPS [H W]]
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 20


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_automask_cli: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    n_clips = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    hw = (int(sys.argv[2]), int(sys.argv[3])) if len(sys.argv) > 3 \
        else (480, 640)
    sys.path.insert(0, REPO)
    import cv2

    import chip_smoke
    from ab_line_classifier_torch.data.auto_masking import UnetSegmentation
    from ab_line_classifier_torch.models.unet import seeded_unet_state

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    root = os.path.join(REPO, "build", "automask_cli")
    shutil.rmtree(root, ignore_errors=True)
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    for k in range(n_clips):
        vw = cv2.VideoWriter(os.path.join(clips, f"clip{k}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             hw[::-1], True)
        for f in chip_smoke.beam_frames(FRAMES, hw, 100 + k):
            vw.write(np.ascontiguousarray(f[..., ::-1]))
        vw.release()
    state = seeded_unet_state(16, 8)
    warm = UnetSegmentation(device="cuda")
    warm.model.load_state_dict(state)
    for _ in range(2):
        warm.eager(chip_smoke.beam_frames(FRAMES, hw, 99)[::2], hw)
    del warm
    try:
        for i, mode in enumerate(("graphed", "eager", "eager", "graphed")):
            seg = UnetSegmentation(device="cuda")
            seg.model.load_state_dict(state)
            mask_call = seg.clip_mask
            calls = []

            def timed(frames, native_hw, edge_preserve=0.95,
                      mask_call=mask_call, seg=seg, mode=mode, calls=calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "graphed":
                    out = mask_call(frames, native_hw, edge_preserve)
                else:
                    mask = seg.eager(frames, native_hw, edge_preserve)
                    out = mask, seg.get_bounding_box(mask)
                torch.cuda.synchronize()
                calls.append((time.perf_counter() - t0) * 1e3)
                return out

            seg.clip_mask = timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg.predict(clips, os.path.join(root, f"run{i}"))
            wall = time.perf_counter() - t0
            replays = sum(s["replays"] for s in seg.summaries().values())
            print(json.dumps({
                "run": i, "mode": mode, "clips": n_clips,
                "hw": list(hw), "wall_s_per_clip": wall / n_clips,
                "mask_ms_first": calls[0], "mask_ms_second": calls[1],
                "mask_ms_median_rest": float(np.median(calls[2:])),
                "rest_s_per_clip": (wall - sum(calls) / 1e3) / n_clips,
                "replay_share": replays / n_clips,
                "programs": {k: (s["eager_steps"], s["replays"],
                                 s["capture_seconds"])
                             for k, s in seg.summaries().items()},
                "device": smi}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
