"""End-to-end quickstart of the PyTorch port on a generated synthetic
dataset: no real data, no outside service (the counterpart of the JAX
package's ``examples/quickstart_synthetic.py``).

Generates a small class-conditional LUS-like dataset (a frames directory
of ``{clip}_{idx}.jpg`` plus frames and clips CSVs, ``data/synthetic.py``),
writes a derived ``config.yml`` into the workspace, then drives the whole
lifecycle through the port's API:

    train (single_train) -> checkpoint -> frame + clip predictions ->
    Grad-CAM heatmaps of 3 frames

and prints the artifact paths and the matching CLI commands (each step has
a CLI driven by the workspace config). It runs on ``cuda`` unless given
``--device cpu``::

    python -m ab_line_classifier_torch.quickstart [--workspace DIR]
        [--epochs N] [--device cuda|cpu]

pandas, PIL, PyYAML and matplotlib are needed, as by the CLIs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_config(ws: str, fcsv: str, ccsv: str, fdir: str, epochs: int):
    """A workspace config derived from the repository's ``config.yml``:
    every PATHS output under the workspace, the problem cut to quickstart
    size (cnn0, 32x32, batch 16)."""
    from ab_line_classifier_torch.config import Config, load_config

    d = load_config(os.path.join(REPO_ROOT, "config.yml")).to_dict()
    d["PATHS"].update({
        "FRAME_TABLE": fcsv, "CLIPS_TABLE": ccsv, "FRAMES": fdir,
        "PARTITIONS": ws + "/partitions/",
        "MODEL_WEIGHTS": ws + "/results/models/",
        "MODEL_TO_LOAD": ws + "/results/models/latest",
        "METRICS": ws + "/results/metrics/",
        "BATCH_PREDS": ws + "/results/predictions/",
        "EXPERIMENTS": ws + "/results/experiments/",
        "LOGS": ws + "/results/logs/",
        "IMAGES": ws + "/results/figures/",
        "HEATMAPS": ws + "/img/heatmaps",
        "EXPERIMENT_VISUALIZATIONS": ws + "/img/experiments/",
        "CLASS_NAME_MAP": ws + "/class_map.json",
    })
    d["TRACKER"]["DIR"] = ws + "/results/runs/"
    d["TRACKER"]["ARTIFACTS_DIR"] = ws + "/results/artifacts/"
    d["DATA"]["IMG_DIM"] = [32, 32]
    d["TRAIN"].update({"MODEL_DEF": "cnn0", "EXPERIMENT_TYPE": "single_train",
                       "EPOCHS": epochs, "BATCH_SIZE": 16, "PATIENCE": 5,
                       "MIXED_PRECISION": False})
    d["HPARAMS"]["CNN0"].update({"BLOCKS": 1, "INIT_FILTERS": 4,
                                 "NODES_DENSE0": 8})
    return Config(d)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="synthetic end-to-end quickstart of the PyTorch port")
    ap.add_argument("--workspace", default="quickstart_ws")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on (default cuda; there is no "
                         "silent fallback to the CPU)")
    args = ap.parse_args(argv)

    import pandas as pd
    import torch
    import yaml

    from ab_line_classifier_torch import resolve_device
    from ab_line_classifier_torch.data.pipeline import FrameDataset
    from ab_line_classifier_torch.data.synthetic import generate_dataset
    from ab_line_classifier_torch.explain.gradcam import GradCAMExplainer
    from ab_line_classifier_torch.predict.predict import (
        compute_clip_predictions, compute_frame_predictions,
        default_predictor)
    from ab_line_classifier_torch.train.experiment import perform_single_run

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
    print(f"device: {device} ({name})")
    ws = os.path.abspath(args.workspace)
    os.makedirs(ws, exist_ok=True)

    print(f"[1/4] generating synthetic dataset under {ws}")
    fcsv, ccsv, fdir = generate_dataset(ws, n_patients=24,
                                        clips_per_patient=2,
                                        frames_per_clip=6, hw=(48, 64),
                                        seed=3)
    cfg = build_config(ws, fcsv, ccsv, fdir, args.epochs)
    cfg_path = os.path.join(ws, "config.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
    print(f"      wrote {cfg_path} (use it with the CLIs: "
          f"--config {cfg_path})")

    print(f"[2/4] training cnn0 ({args.epochs} epochs, single_train)")
    result = perform_single_run(cfg, save_weights=True, verbose=True,
                                device=device)
    print(f"      checkpoint: {result.model_dir}")
    scalars = {k: round(float(v), 3) for k, v in result.test_metrics.items()
               if np.isscalar(v)}
    print(f"      test metrics: {scalars}")

    print("[3/4] frame + clip predictions")
    # One restore and ONE frame sweep feed both passes, as in the predict
    # CLI.
    predictor = default_predictor(cfg, device)
    frame_probs = predictor.predict_dataset(
        FrameDataset(pd.read_csv(fcsv), fdir, img_dim=cfg.img_dim))
    clip_df = compute_clip_predictions(cfg, fcsv, ccsv, class_thresh=0.5,
                                       clip_algorithm="average",
                                       predictor=predictor,
                                       frame_probs=frame_probs)
    frame_df = compute_frame_predictions(cfg, fcsv, class_thresh=0.5,
                                         predictor=predictor,
                                         frame_probs=frame_probs)
    print(f"      {len(frame_df)} frame predictions, {len(clip_df)} clip "
          f"predictions -> {cfg['PATHS']['BATCH_PREDS']}")

    print("[4/4] Grad-CAM heatmaps for 3 frames")
    GradCAMExplainer(cfg, device=device).apply_gradcam(
        pd.read_csv(fcsv).head(3))
    print(f"      heatmap PNGs -> {cfg['PATHS']['HEATMAPS']}")

    print("\nDone. Follow-up CLI commands against this workspace:")
    dev = f" --device {args.device}"
    for cmd in (
            "python -m ab_line_classifier_torch.predict",
            "python -m ab_line_classifier_torch.explain --limit 3",
            "python -m ab_line_classifier_torch.export --model "
            f"{ws}/results/models/latest --out {ws}/model.onnx"):
        print(f"  {cmd} --config {cfg_path}{dev}")


if __name__ == "__main__":
    main()
