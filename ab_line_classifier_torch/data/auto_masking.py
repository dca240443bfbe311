"""Ultrasound-beam auto-masking (port of the JAX package's
``data/auto_masking.py``; the reference's ``src/data/auto_masking.py``).

Scrubs raw clips of on-screen information extraneous to the ultrasound
beam: a U-Net predicts beam-probability masks on a sample of frames,
morphology cleans them, a majority vote forms the clip mask, and every
frame is masked (optionally cropped to the beam's bounding box).

The reference's behaviour is kept: sample every ``max(floor(10%), 1)``-th
frame; grayscale, scikit-image 0.19.1's anti-aliased downsample to 128x128
and /255; threshold at 0.4; bilinear upsample of the binary mask to the
source size, every touched pixel in the support; elliptical erode by the
edge-preserve kernel, dilate by the 5%-of-height kernel; a 5x5-smoothed
majority vote; the bounding box; jpg or mp4 output and a ``mask.jpg`` per
clip.

On the device the sampled frames run as one batched U-Net forward and the
threshold / morphology / vote chain as tensor ops (``ops/morphology.py``).
The chain thresholds float values twice (the U-Net's probability and the
upsampled support) and so runs in IEEE float32: TF32 convolutions and
products are turned off for the duration of each call
(:func:`ieee_float32`), whatever the process's setting. Video files are
read and written on the host with cv2, imported by :meth:`predict` only.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.models.unet import UNet, import_h5_unet_weights
from ab_line_classifier_torch.ops import morphology as M
from ab_line_classifier_torch.ops.image import (linear_resize,
                                                skimage_downsample)
from ab_line_classifier_torch.utils import checkpoint as ckpt

UNET_INPUT = (128, 128)
PROB_THRESHOLD = 0.4


@contextlib.contextmanager
def ieee_float32():
    """Float32 convolutions and products in IEEE float32 (no TF32) inside
    the block; the process's settings are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _require_cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("reading and writing clips needs cv2 (opencv); "
                           "predict_masks / clip_mask / mask_frames take "
                           "decoded frames without it") from e
    return cv2


class UnetSegmentation:
    """The reference's ``UnetSegmentation`` with a batched compute path on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, model_path: Optional[str] = None,
                 base_filters: int = 16, device=None):
        self.device = resolve_device(device)
        self.model = UNet(base_filters=base_filters).eval().to(self.device)
        self.loaded = False
        if model_path:
            self.load(model_path)

    def load(self, model_path: str) -> None:
        """Restore U-Net weights from a port checkpoint directory
        (``utils/checkpoint.py``; ``scripts/orbax_to_torch.py`` converts the
        JAX package's) or a Keras ``.h5`` (the reference's format, imported
        by position and shape). Anything else raises: a medical dataset is
        never masked with silently random weights."""
        if os.path.isdir(model_path):
            state, _ = ckpt.load_model(model_path)
            model = UNet(base_filters=int(state["enc0_conv1.weight"].shape[0]))
            model.load_state_dict(state)
            self.model = model.eval().to(self.device)
        elif os.path.isfile(model_path) and model_path.endswith(
                (".h5", ".hdf5")):
            state = import_h5_unet_weights(model_path,
                                           self.model.state_dict())
            self.model.load_state_dict(state)
        else:
            raise FileNotFoundError(
                f"automask model {model_path!r} is neither a checkpoint "
                f"directory nor a .h5 file")
        self.loaded = True

    def get_bounding_box(self, binary_mask) -> list:
        """``[min_i, max_i, min_j, max_j]`` of the mask's nonzero area."""
        return list(M.bounding_box(binary_mask))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict_masks(self, frames_u8) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` RGB (or ``[B, H, W]``) frames, an array or
        a tensor -> ``[B, 128, 128]`` float32 beam probabilities on the
        device: grayscale (cv2's weights, in float64 as the reference's
        numpy), the skimage downsample, /255, one batched U-Net forward."""
        x = torch.as_tensor(frames_u8).to(self.device, torch.float64)
        if x.ndim == 4:
            x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        with ieee_float32():
            x = skimage_downsample(x.to(torch.float32), UNET_INPUT) / 255.0
            return self.model(x[..., None])[..., 0]

    @torch.inference_mode()
    def mask_from_probs(self, probs: torch.Tensor,
                        native_hw: Tuple[int, int],
                        edge_preserve: float = 0.95) -> torch.Tensor:
        """``[B, 128, 128]`` probabilities -> the ``[H, W]`` float32 0/1 clip
        mask: threshold at 0.4, bilinear upsample (support: every pixel
        the interpolation touches, cv2 INTER_LINEAR + THRESH_BINARY), erode
        by the ``max(int(h * (1 - edge_preserve)), 3)`` ellipse, dilate by
        the ``max(int(h * 0.05), 3)`` one, majority vote."""
        h, w = native_hw
        with ieee_float32():
            binary128 = (probs > PROB_THRESHOLD).to(torch.float32)
            support = (linear_resize(binary128, (h, w)) > 0).to(
                torch.float32)
            cleaned = M.clean_binary_masks(
                support, erode_size=max(int(h * (1 - edge_preserve)), 3),
                dilate_size=max(int(h * 0.05), 3))
            return M.majority_average_mask(cleaned)

    def clip_mask(self, sampled_frames_u8, native_hw: Tuple[int, int],
                  edge_preserve: float = 0.95
                  ) -> Tuple[torch.Tensor, list]:
        """The clip's ``[H, W]`` mask (a float32 0/1 tensor on the device)
        and its bounding box, from the sampled frames (the reference's
        per-clip loop, batched)."""
        mask = self.mask_from_probs(self.predict_masks(sampled_frames_u8),
                                    native_hw, edge_preserve)
        return mask, self.get_bounding_box(mask)

    # ------------------------------------------------------------------
    def mask_frames(self, frames_u8, mask,
                    bbox: Optional[list] = None) -> torch.Tensor:
        """Apply a clip mask to ``[B, H, W, 3]`` uint8 frames on the device,
        and crop to ``bbox`` (the reference's exclusive upper bounds)."""
        frames = torch.as_tensor(frames_u8).to(self.device)
        mask = torch.as_tensor(mask).to(self.device)
        out = frames * mask.to(frames.dtype)[None, :, :, None]
        if bbox is not None:
            out = out[:, bbox[0]:bbox[1], bbox[2]:bbox[3]]
        return out

    def predict(self, input_paths: str, output_path: str,
                model_path: Optional[str] = None, output_format: str = "jpg",
                edge_preserve: float = 0.95,
                save_cropped_roi: bool = False) -> None:
        """The reference's CLI surface: walk the mp4s under
        ``input_paths`` and write masked jpgs or an mp4, plus ``mask.jpg``,
        per clip. Pass 1 decodes the clip and keeps every step-th frame
        for the batched U-Net; pass 2 streams the frames again, masking and
        writing one at a time, so the host holds one frame and the
        sample."""
        cv2 = _require_cv2()
        if model_path:
            self.load(model_path)
        if not self.loaded:
            logging.warning("no automask model loaded; using random init "
                            "(masks will be meaningless until trained)")

        video_files = glob.glob(input_paths + "/**/*.mp4", recursive=True)
        os.makedirs(output_path, exist_ok=True)
        os.makedirs(os.path.join(output_path, "bad_clips"), exist_ok=True)
        for clip_index, file in enumerate(video_files):
            tail = os.path.basename(file)
            out_dir = os.path.join(output_path, tail[:-4])
            os.makedirs(out_dir, exist_ok=True)

            cap = cv2.VideoCapture(file)
            num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            fw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            fh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            fps = float(cap.get(cv2.CAP_PROP_FPS))
            sampled = []
            step = max(int(num_frames * 0.1), 1) if num_frames > 0 else 10
            idx = 0
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                if idx == 0:
                    # Trust the decoded pixels over the metadata.
                    fh, fw = frame.shape[:2]
                if idx % step == 0:
                    sampled.append(frame[..., ::-1].copy())
                idx += 1
            cap.release()
            if not np.isfinite(fps) or fps <= 0:
                fps = 30.0
            if not sampled:
                logging.warning("no frames in %s", file)
                continue
            mask, bbox = self.clip_mask(np.stack(sampled), (fh, fw),
                                        edge_preserve=edge_preserve)
            del sampled
            mask = mask.cpu().numpy()
            crop = (bbox if (save_cropped_roi and output_format == "jpg")
                    else None)
            mask_u8 = mask.astype(np.uint8)[:, :, None]

            cap = cv2.VideoCapture(file)
            video = None
            if output_format == "mp4":
                video = cv2.VideoWriter(
                    os.path.join(out_dir, tail[:-4] + ".mp4"),
                    cv2.VideoWriter_fourcc(*"mp4v"), fps, (fw, fh), True)
            i = 0
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                fr = frame * mask_u8
                if crop is not None:
                    fr = fr[crop[0]:crop[1], crop[2]:crop[3]]
                if output_format == "jpg":
                    cv2.imwrite(os.path.join(out_dir, f"{i}.jpg"), fr)
                elif video is not None:
                    video.write(np.ascontiguousarray(fr))
                i += 1
            cap.release()
            if video is not None:
                video.release()
            cv2.imwrite(os.path.join(out_dir, "mask.jpg"),
                        (mask * 255).astype(np.uint8))
            logging.info("masked clip %d/%d: %s", clip_index + 1,
                         len(video_files), tail)


def main(argv=None):
    """``python -m ab_line_classifier_torch.data.auto_masking -i <clips>
    -o <out> -m <unet> -f jpg|mp4 [-e 0.95] [-c] [--device cpu]``."""
    import argparse

    logging.basicConfig(format="[%(levelname)s] %(message)s",
                        level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input_path", required=True)
    ap.add_argument("-o", "--output_path", required=True)
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("-f", "--output_format", required=True)
    ap.add_argument("-e", "--edge_preserve", type=float, default=0.95)
    ap.add_argument("-c", "--save_cropped_roi", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not 0.0 <= args.edge_preserve <= 1.0:
        raise ValueError("edge_preserve has to be in [0 1]")
    seg = UnetSegmentation(device=args.device)
    seg.predict(args.input_path, args.output_path, args.model_path,
                output_format=args.output_format,
                edge_preserve=args.edge_preserve,
                save_cropped_roi=args.save_cropped_roi)


if __name__ == "__main__":
    main()
