"""Per-epoch evaluation callbacks (port of the JAX package's
``train/callbacks.py``).

:class:`PredictionTableLogger` logs, after every epoch, a table of the
first ``max_rows`` validation frames (``epoch, idx, frame, label, probs,
pred``, a CSV per epoch under the tracker's run directory) through the
port's :class:`~ab_line_classifier_torch.predict.predict.Predictor`
(kernel B1 on CUDA), and Grad-CAM heatmap PNGs of the first
``n_heatmaps`` rows through the port's Grad-CAM pass. As the JAX
package compiles its table forward and Grad-CAM pass once a run, the
logger keeps one ``Predictor`` and one Grad-CAM pass for its life: each
epoch's weights are copied into the same module in place
(``load_state_dict``), so the table forward and the heatmap pass, each a
CUDA graph on the card, are captured once a run (at the second epoch)
and replayed in every later epoch. The CSV is written with the standard
library: no pandas. Under a device mesh every rank runs the same pass (a
sharded cache's gathers are collectives) and rank 0 writes.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ab_line_classifier_torch.parallel.mesh import is_main


class PredictionTableLogger:
    """Batched per-epoch prediction table of ``val_ds`` (a
    :class:`FrameDataset` or a :class:`DeviceCachedDataset`)."""

    def __init__(self, spec, val_ds, *, tracker=None, max_rows: int = 64,
                 n_heatmaps: int = 0, heatmap_dir: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        self.spec = spec
        self.val_ds = val_ds
        self.tracker = tracker
        self.max_rows = max_rows
        self.n_heatmaps = n_heatmaps
        self.heatmap_dir = heatmap_dir
        self.compute_dtype = compute_dtype
        self.device = device
        self.predictor = None
        self.gradcam = None

    def _predictor(self, state_dict):
        """The logger's one predictor, holding ``state_dict`` (copied into
        its module in place after the first epoch)."""
        from ab_line_classifier_torch.predict.predict import Predictor

        if self.predictor is None:
            self.predictor = Predictor(
                self.spec, state_dict,
                batch_size=min(64, max(1, self.max_rows)),
                compute_dtype=self.compute_dtype, device=self.device)
        else:
            self.predictor.module.load_state_dict(state_dict)
            self.predictor.weights = state_dict
        return self.predictor

    def on_epoch_end(self, epoch: int, state_dict) -> List[Dict]:
        predictor = self._predictor(state_dict)
        paths = self.val_ds.frame_paths
        rows: List[Dict] = []
        heat = []
        for batch in self.val_ds.batches(predictor.batch_size):
            images = torch.as_tensor(batch.images).to(predictor.device)
            probs = predictor.forward(images).cpu().numpy()
            labels = np.asarray(torch.as_tensor(batch.labels).cpu())
            for j in np.nonzero(batch.mask > 0)[0][:self.max_rows - len(rows)]:
                idx = int(batch.indices[j])
                rows.append({"epoch": epoch, "idx": idx, "frame": paths[idx],
                             "label": int(labels[j]),
                             "probs": probs[j].round(5).tolist(),
                             "pred": int(np.argmax(probs[j]))})
                if len(heat) < self.n_heatmaps:
                    heat.append((images[j], rows[-1]))
            if len(rows) >= self.max_rows:
                break

        run_dir = getattr(self.tracker, "run_dir", None)
        if not is_main():
            return rows
        if run_dir and rows:
            out = os.path.join(run_dir, "val_predictions")
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, f"epoch_{epoch:03d}.csv"), "w",
                      newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
        if heat and self.heatmap_dir:
            self._heatmaps(predictor, heat, epoch)
        return rows

    def _heatmaps(self, predictor, heat, epoch: int) -> None:
        from ab_line_classifier_torch.explain.gradcam import (
            build_fused_gradcam, heatmap_overlay)
        from ab_line_classifier_torch.viz.visualization import (
            visualize_heatmap)

        if self.gradcam is None:
            self.gradcam = build_fused_gradcam(self.spec, predictor.module)
        probs, cams = self.gradcam(torch.stack([im for im, _ in heat]))
        probs, cams = probs.cpu().numpy(), cams.cpu().numpy()
        names = [str(i) for i in range(self.spec.n_classes)]
        for k, (im, row) in enumerate(heat):
            im = im.cpu().numpy()
            # Epoch and row in the name: same-named frames and successive
            # epochs do not overwrite one another.
            name = f"epoch{epoch:03d}_{k}_{os.path.basename(row['frame'])}"
            visualize_heatmap(im, heatmap_overlay(im, cams[k]), name,
                              row["label"], probs[k], names,
                              dir_path=self.heatmap_dir)
