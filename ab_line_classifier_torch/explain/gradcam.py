"""Grad-CAM as one forward and one gradient pass per batch (port of the JAX
package's ``explain/gradcam.py``).

The reference runs, per frame, an eager ``tf.GradientTape`` over a
two-output Keras model. The JAX package runs a whole batch as one jitted
program; here a batch is one forward and one ``torch.autograd.grad``:

    preprocess (kernel B1 on the GPU) -> forward, the last conv's output
    made an autograd leaf -> the rest of the graph -> d score / d tap for
    the one-hot argmax class -> channel weights -> weighted channel sum ->
    ReLU -> per-image normalize -> bilinear upsample to IMG_DIM

so probabilities and heatmaps come from the same pass. The tap is the last
conv-like layer (``ModelSpec.last_conv_layer``). Everything before it runs
once and is not recorded by autograd (``GraphModule.forward``'s ``leaf``;
the parameters do not require grad), so memory and time of the backward
cover only the layers after the tap. On the GPU every stride-1 depthwise
layer of the forward runs kernel B2; none lies after any zoo model's tap.

Both weighting modes of the reference config
(``EXPLAINABILITY.GRAD_CAM.MODE``) are implemented: ``normal``
(global-average-pooled gradients) and ``plusplus`` (Grad-CAM++ alpha
weighting). In a bfloat16 model the tap, its gradient and the heatmap math
stay in bfloat16, as the JAX package's dtype promotion keeps them; the
heatmaps come back as float32.

pandas, PIL and matplotlib are imported only by the table and figure
methods of :class:`GradCAMExplainer`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.models import build_model
from ab_line_classifier_torch.models.common import ModelSpec
from ab_line_classifier_torch.ops.preprocess_cuda import preprocess_frames
from ab_line_classifier_torch.predict.predict import load_module
from ab_line_classifier_torch.utils import checkpoint as ckpt
from ab_line_classifier_torch.utils.profiling import annotate

MODES = ("normal", "plusplus")

JET_ANCHORS = np.array([
    # OpenCV COLORMAP_JET-style RGB anchors at t = 0, .125, .375, .625, .875, 1
    [0, 0, 128], [0, 0, 255], [0, 255, 255], [255, 255, 0], [255, 0, 0],
    [128, 0, 0]], dtype=np.float32)
JET_POS = np.array([0.0, 0.125, 0.375, 0.625, 0.875, 1.0], dtype=np.float32)


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Map [0, 1] heat values to JET RGB uint8 (``cv2.applyColorMap`` in
    shape and spirit, without cv2)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    out = np.stack([np.interp(x, JET_POS, JET_ANCHORS[:, c])
                    for c in range(3)], axis=-1)
    return out.astype(np.uint8)


def heatmap_overlay(orig_img: np.ndarray, cam: np.ndarray,
                    intensity: float = 0.5) -> np.ndarray:
    """JET-coloured heat blended over the original frame (the reference's
    0.5 / 0.5 ``addWeighted``)."""
    heat_rgb = jet_colormap(cam).astype(np.float32)
    blend = (heat_rgb * intensity
             + np.asarray(orig_img, np.float32) * (1.0 - intensity))
    return np.clip(blend, 0, 255).astype(np.uint8)


def build_fused_gradcam(spec: ModelSpec, module: torch.nn.Module,
                        mode: str = "normal",
                        out_hw: Optional[Tuple[int, int]] = None
                        ) -> Callable[[torch.Tensor],
                                      Tuple[torch.Tensor, torch.Tensor]]:
    """The batched Grad-CAM pass of ``spec`` through ``module`` (its graph
    module, in eval mode, on the device the frames will lie on; see
    ``predict.load_module``). Returns ``fn(frames_u8) -> (probs float32
    [B, C], heatmaps float32 [B, H, W] in [0, 1])`` for uint8 ``[B, H_src,
    W_src, 3]`` frames on that device; ``(H, W)`` is ``out_hw`` (default
    the model's input size), which the tap must not exceed.

    The module's parameters are set not to require grad. ``fn`` records
    autograd itself: do not call it under ``torch.inference_mode``."""
    if mode not in MODES:
        raise ValueError(f"Grad-CAM mode {mode!r} not one of {MODES}")
    tap = spec.last_conv_layer
    in_hw = tuple(spec.input_shape[:2])
    hw = tuple(out_hw or in_hw)
    module.requires_grad_(False)

    def fused(frames_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with annotate("gradcam.preprocess"):
            x = preprocess_frames(frames_u8, out_hw=in_hw,
                                  preprocess_mode=spec.preprocess_mode,
                                  out_dtype=spec.dtype)
        with torch.enable_grad():
            with annotate("gradcam.forward"):
                probs, caps = module(x, leaf=tap)
            a = caps[tap]                                  # [B, h, w, C]
            cls = probs.argmax(dim=-1, keepdim=True)
            # d probs[b, cls_b] / d a: the vjp of the one-hot cotangent.
            with annotate("gradcam.gradient"):
                grads, = torch.autograd.grad(probs.gather(1, cls).sum(), a)
        a = a.detach()
        if a.shape[1] > hw[0] or a.shape[2] > hw[1]:
            raise ValueError(f"the tap {tap!r} ({tuple(a.shape[1:3])}) is "
                             f"larger than the heatmap {hw}")
        with annotate("gradcam.heatmap"):
            return probs.detach(), _heatmaps(a, grads, mode, hw)

    return fused


def _heatmaps(a: torch.Tensor, grads: torch.Tensor, mode: str,
              hw: Tuple[int, int]) -> torch.Tensor:
    """Heatmaps float32 ``[B, *hw]`` in [0, 1] from the tap ``a`` and its
    gradient, both ``[B, h, w, C]`` in the model's dtype."""
    if mode == "plusplus":
        # Grad-CAM++ (Chattopadhay et al. 2018): alpha-weighted positive
        # gradients.
        g2 = grads * grads
        g3 = g2 * grads
        denom = 2.0 * g2 + (a * g3).sum(dim=(1, 2), keepdim=True)
        alpha = torch.where(denom.abs() > 1e-12, g2 / denom,
                            torch.zeros_like(g2))
        weights = (alpha * F.relu(grads)).sum(dim=(1, 2))
    else:
        weights = grads.mean(dim=(1, 2))
    cam = F.relu(torch.einsum("bhwc,bc->bhw", a, weights))
    cam = cam / torch.clamp(cam.amax(dim=(1, 2), keepdim=True), min=1e-12)
    # Bilinear upsample, half-pixel centres, edges clamped: for an upsample,
    # jax.image.resize's renormalised triangle kernel.
    cam = F.interpolate(cam[:, None], size=hw, mode="bilinear",
                        align_corners=False, antialias=False)[:, 0]
    return cam.to(torch.float32)


class GradCAMExplainer:
    """The reference's ``GradCAMExplainer`` on the batched pass: a restored
    model on one device (``cuda`` unless ``device`` says otherwise)."""

    def __init__(self, cfg: Config, spec: Optional[ModelSpec] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 mode: Optional[str] = None, device=None):
        if spec is None or state_dict is None:
            # Fill in only what the caller left out: a given spec or state
            # is never replaced by the checkpoint's.
            loaded, meta = ckpt.load_model(cfg["PATHS"]["MODEL_TO_LOAD"])
            if state_dict is None:
                state_dict = loaded
            if spec is None:
                # mixed_precision from meta.json, as Predictor.restore: a
                # bf16-serving checkpoint is explained in bf16, so each
                # annotated class is the one the served model predicts.
                spec = build_model(meta["model_name"], meta["hparams"],
                                   tuple(meta["input_shape"]),
                                   int(meta["n_classes"]),
                                   mixed_precision=bool(
                                       meta.get("mixed_precision", False)))
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.module = load_module(spec, state_dict, self.device)
        self.img_dim = tuple(cfg.img_dim)
        self.classes = cfg.classes
        self.save_img_dir = cfg["PATHS"]["HEATMAPS"]
        self.frames_dir = cfg["PATHS"]["FRAMES"]
        self.hm_intensity = 0.5
        self.mode = (mode or cfg["EXPLAINABILITY"]["GRAD_CAM"]["MODE"]).lower()
        self.conv_layer = spec.last_conv_layer
        self._fused = build_fused_gradcam(spec, self.module, self.mode,
                                          out_hw=self.img_dim)

    def explain_frames(self, frames_u8: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 host frames ``[B, H, W, 3]`` -> (probabilities ``[B, C]``,
        heatmaps ``[B, IMG_DIM]`` in [0, 1]), float32, from one pass."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8))
        probs, cams = self._fused(frames.to(self.device))
        return probs.cpu().numpy(), cams.cpu().numpy()

    def heatmap_overlay(self, orig_img: np.ndarray,
                        cam: np.ndarray) -> np.ndarray:
        return heatmap_overlay(orig_img, cam, self.hm_intensity)

    def apply_gradcam(self, frame_df, save: bool = True) -> np.ndarray:
        """A heatmap panel PNG per row of the frames table ``frame_df``
        (batches of at most 32 frames) into ``PATHS.HEATMAPS``; returns the
        last heatmap."""
        from ab_line_classifier_torch.data.pipeline import (CLASS,
                                                            FRAME_PATH,
                                                            FrameDataset)
        from ab_line_classifier_torch.viz.visualization import (
            visualize_heatmap)

        ds = FrameDataset(frame_df, self.frames_dir, img_dim=self.img_dim)
        heatmap = None
        for batch in ds.batches(min(32, max(1, len(ds)))):
            probs, cams = self.explain_frames(batch.images)
            for j in np.nonzero(batch.mask > 0)[0]:
                row = frame_df.iloc[int(batch.indices[j])]
                orig = batch.images[j]
                heatmap = cams[j]
                if save:
                    visualize_heatmap(orig, self.heatmap_overlay(orig,
                                                                 heatmap),
                                      str(row[FRAME_PATH]), int(row[CLASS]),
                                      probs[j], self.classes,
                                      dir_path=self.save_img_dir)
        return heatmap

    def get_heatmap_for_frame(self, frame_path: str, frame_df=None):
        """Explain one named frame of the frames table (matched by file
        name; the reference asks with a file dialog)."""
        import pandas as pd

        if frame_df is None:
            frame_df = pd.read_csv(self.cfg["PATHS"]["FRAME_TABLE"])
        filtered = frame_df[frame_df["Frame Path"]
                            == os.path.basename(frame_path)]
        filtered = filtered.reset_index(drop=True)
        if not len(filtered):
            raise FileNotFoundError(
                f"frame {frame_path!r} not found in frame table")
        return self.apply_gradcam(filtered)
