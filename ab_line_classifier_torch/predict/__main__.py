"""CLI entry point: ``python -m ab_line_classifier_torch.predict``.

The same command line as the JAX package's predict CLI:
clip predictions with the configured algorithm and threshold, then frame
predictions at threshold 0.5, from one frame sweep. ``--device`` picks the
device (default ``cuda``; ``cpu`` runs the plain PyTorch path).
"""

import argparse

from ab_line_classifier_torch.config import load_config


def main():
    p = argparse.ArgumentParser(description="Frame + clip inference")
    p.add_argument("--config", default=None, help="path to config.yml")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip metrics (no ground-truth column)")
    p.add_argument("--ext-val", action="store_true",
                   help="predict on the external-validation dataset "
                        "(PATHS.EXT_VAL_FRAME_TABLE / EXT_VAL_CLIPS_TABLE /"
                        " EXT_VAL_FRAMES)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to serve on (default cuda; there is no "
                        "silent fallback to the CPU)")
    args = p.parse_args()

    cfg = load_config(args.config)
    if args.ext_val:
        needed = ("EXT_VAL_FRAME_TABLE", "EXT_VAL_CLIPS_TABLE",
                  "EXT_VAL_FRAMES")
        missing = [k for k in needed if not cfg["PATHS"].get(k)]
        if missing:
            raise SystemExit(
                f"--ext-val needs PATHS.{'/'.join(missing)} in the config")
        frames_path = cfg["PATHS"]["EXT_VAL_FRAME_TABLE"]
        clips_path = cfg["PATHS"]["EXT_VAL_CLIPS_TABLE"]
        frames_dir = cfg["PATHS"]["EXT_VAL_FRAMES"]
    else:
        frames_path = cfg["PATHS"]["FRAME_TABLE"]
        clips_path = cfg["PATHS"]["CLIPS_TABLE"]
        frames_dir = cfg["PATHS"]["FRAMES"]

    import pandas as pd

    from ab_line_classifier_torch.data.pipeline import FrameDataset
    from ab_line_classifier_torch.predict.predict import (
        compute_clip_predictions, compute_frame_predictions,
        default_predictor)

    # One restore and ONE frame sweep shared by both passes: thresholds
    # apply downstream of the probabilities.
    predictor = default_predictor(cfg, args.device)
    ds = FrameDataset(pd.read_csv(frames_path), frames_dir,
                      img_dim=cfg.img_dim)
    frame_probs = predictor.predict_dataset(ds)
    compute_clip_predictions(
        cfg, frames_path, clips_path,
        class_thresh=float(cfg["CLIP_PREDICTION"]["CLASSIFICATION_THRESHOLD"]),
        clip_algorithm=cfg["CLIP_PREDICTION"]["ALGORITHM"],
        calculate_metrics=not args.no_metrics, predictor=predictor,
        frames_dir=frames_dir, frame_probs=frame_probs)
    compute_frame_predictions(cfg, frames_path, class_thresh=0.5,
                              calculate_metrics=not args.no_metrics,
                              predictor=predictor, frames_dir=frames_dir,
                              frame_probs=frame_probs)


if __name__ == "__main__":
    main()
