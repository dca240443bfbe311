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

Like the JAX package's jitted U-Net predict and morphology, the whole
chain from the sampled frames to the clip mask is one program per
sampled-clip shape (:meth:`UnetSegmentation.clip_mask`): on CUDA a CUDA
graph (``train/graphed.py::StepGraph``) captured inside the IEEE scope,
so a replay runs IEEE kernels whatever the process's TF32 flags are.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.data.pipeline import PinnedStaging
from ab_line_classifier_torch.models.unet import UNet, import_h5_unet_weights
from ab_line_classifier_torch.ops import morphology as M
from ab_line_classifier_torch.ops.image import (linear_resize,
                                                skimage_downsample)
from ab_line_classifier_torch.train.graphed import StepGraph, capturable
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


def kernel_sizes(h: int, edge_preserve: float = 0.95) -> Tuple[int, int]:
    """The erode and dilate ellipses' sizes for a clip of ``h`` rows:
    ``max(int(h * (1 - edge_preserve)), 3)`` and ``max(int(h * 0.05), 3)``."""
    return max(int(h * (1 - edge_preserve)), 3), max(int(h * 0.05), 3)


def beam_probs(model: UNet, frames: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` RGB (or ``[B, H, W]``) frames on the model's
    device -> ``[B, 128, 128]`` float32 beam probabilities: grayscale
    (cv2's weights, in float64 as the reference's numpy), the skimage
    downsample, /255, one batched U-Net forward, in IEEE float32."""
    x = frames.to(torch.float64)
    if x.ndim == 4:
        x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    with ieee_float32():
        x = skimage_downsample(x.to(torch.float32), UNET_INPUT) / 255.0
        return model(x[..., None])[..., 0]


def probs_to_mask(probs: torch.Tensor, native_hw: Tuple[int, int],
                  erode_size: int, dilate_size: int) -> torch.Tensor:
    """``[B, 128, 128]`` probabilities -> the ``[H, W]`` float32 0/1 clip
    mask, in IEEE float32: threshold at 0.4, bilinear upsample (support:
    every pixel the interpolation touches, cv2 INTER_LINEAR +
    THRESH_BINARY), elliptical erode and dilate, majority vote."""
    with ieee_float32():
        binary128 = (probs > PROB_THRESHOLD).to(torch.float32)
        support = (linear_resize(binary128, native_hw) > 0).to(torch.float32)
        cleaned = M.clean_binary_masks(support, erode_size=erode_size,
                                       dilate_size=dilate_size)
        return M.majority_average_mask(cleaned)


class UnetSegmentation:
    """The reference's ``UnetSegmentation`` with a batched compute path on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    Like the JAX package's jitted programs, :meth:`clip_mask` runs one
    program per key ``(sampled frames' shape and dtype, native size,
    erode size, dilate size)``: on CUDA a :class:`~ab_line_classifier_
    torch.train.graphed.StepGraph` whose body reads a fixed input and
    writes the clip mask into a fixed ``[H, W]`` float32 output. A key's
    first call runs the chain eagerly on the shared side stream, its
    second captures it as a CUDA graph and every later call replays it.
    All of a segmentation's graphs share one memory pool. On the CPU the
    same body runs uncaptured each call. A capture that fails raises;
    nothing reruns the chain eagerly in its place. :meth:`eager` is the
    same chain dispatched op by op on the frames themselves."""

    def __init__(self, model_path: Optional[str] = None,
                 base_filters: int = 16, device=None):
        self.device = resolve_device(device)
        self.model = UNet(base_filters=base_filters).eval().to(self.device)
        self.loaded = False
        self.graphed = capturable(self.device)
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._staging = PinnedStaging(self.device)
        self._programs: Dict[tuple, tuple] = {}
        if model_path:
            self.load(model_path)

    def load(self, model_path: str) -> None:
        """Restore U-Net weights from a port checkpoint directory
        (``utils/checkpoint.py``; ``scripts/orbax_to_torch.py`` converts the
        JAX package's) or a Keras ``.h5`` (the reference's format, imported
        by position and shape). Anything else raises: a medical dataset is
        never masked with silently random weights. Weights of the model's
        width are copied into it in place, so its programs' graphs read
        them; a checkpoint of another width replaces the model and drops
        every program."""
        if os.path.isdir(model_path):
            state, _ = ckpt.load_model(model_path)
            width = int(state["enc0_conv1.weight"].shape[0])
            if width != self.model.base_filters:
                self._programs.clear()
                self.model = UNet(base_filters=width).eval().to(self.device)
            self.model.load_state_dict(state)
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
    @property
    def graph_mode(self) -> str:
        """``graphed`` or ``uncaptured``: the path :meth:`clip_mask`
        takes."""
        return "graphed" if self.graphed else "uncaptured"

    def summaries(self) -> Dict[str, Dict]:
        """:meth:`StepGraph.summary` of each program, keyed
        ``"BxHxWxC to HxW, erode e, dilate d"``."""
        return {f"{'x'.join(map(str, shape))} to {hw[0]}x{hw[1]}, erode "
                f"{erode}, dilate {dilate}": step.summary()
                for (shape, _, hw, erode, dilate), (_, _, step)
                in self._programs.items()}

    @torch.inference_mode()
    def predict_masks(self, frames_u8) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` RGB (or ``[B, H, W]``) frames, an array or
        a tensor -> ``[B, 128, 128]`` float32 beam probabilities on the
        device (:func:`beam_probs`)."""
        return beam_probs(self.model,
                          torch.as_tensor(frames_u8).to(self.device))

    @torch.inference_mode()
    def mask_from_probs(self, probs: torch.Tensor,
                        native_hw: Tuple[int, int],
                        edge_preserve: float = 0.95) -> torch.Tensor:
        """``[B, 128, 128]`` probabilities -> the ``[H, W]`` float32 0/1 clip
        mask (:func:`probs_to_mask`): erode by the
        ``max(int(h * (1 - edge_preserve)), 3)`` ellipse, dilate by the
        ``max(int(h * 0.05), 3)`` one."""
        return probs_to_mask(probs, native_hw,
                             *kernel_sizes(native_hw[0], edge_preserve))

    def eager(self, sampled_frames_u8, native_hw: Tuple[int, int],
              edge_preserve: float = 0.95) -> torch.Tensor:
        """The clip's ``[H, W]`` mask, the chain op by op on the frames
        (moved to the device)."""
        return self.mask_from_probs(self.predict_masks(sampled_frames_u8),
                                    native_hw, edge_preserve)

    @torch.inference_mode()
    def clip_mask(self, sampled_frames_u8, native_hw: Tuple[int, int],
                  edge_preserve: float = 0.95
                  ) -> Tuple[torch.Tensor, list]:
        """The clip's ``[H, W]`` mask (a float32 0/1 tensor on the device)
        and its bounding box, from the sampled frames (the reference's
        per-clip loop, batched), through the key's program. Host frames
        are copied into its fixed input through pinned staging buffers,
        device frames directly; the mask is a clone of its fixed output,
        which a later call never overwrites. Everything a program holds is
        made, filled and read in inference mode."""
        frames = torch.as_tensor(sampled_frames_u8)
        fixed, out, step = self._program(
            frames, tuple(int(n) for n in native_hw), edge_preserve)
        if frames.device.type == "cpu":
            self._staging(frames, out=[fixed])
        else:
            fixed.copy_(frames)
        step()
        mask = out.clone()
        return mask, self.get_bounding_box(mask)

    def _program(self, frames: torch.Tensor, native_hw: Tuple[int, int],
                 edge_preserve: float):
        """The key's fixed input, fixed output and step."""
        erode, dilate = kernel_sizes(native_hw[0], edge_preserve)
        key = (tuple(frames.shape), frames.dtype, native_hw, erode, dilate)
        prog = self._programs.get(key)
        if prog is None:
            # The body holds what it reads, not the segmentation: dropping
            # the segmentation frees its graphs without the cycle
            # collector.
            model = self.model
            home = next(model.parameters()).device
            fixed = torch.empty(key[0], dtype=frames.dtype, device=home)
            out = torch.empty(native_hw, dtype=torch.float32, device=home)

            def body():
                with ieee_float32(), torch.inference_mode():
                    out.copy_(probs_to_mask(beam_probs(model, fixed),
                                            native_hw, erode, dilate))

            prog = self._programs[key] = (fixed, out, StepGraph(
                body, home, name="automask", capture=self.graphed,
                pool=self._pool))
        return prog

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
        line = f"Auto-mask programs: {self.graph_mode}"
        if self.graphed:
            line += " (" + "; ".join(
                f"{key}: {s['eager_steps']} eager, {s['replays']} replayed"
                for key, s in self.summaries().items()) + ")"
        logging.info(line)


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
