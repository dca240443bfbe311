"""CLI entry point: ``python -m ab_line_classifier_torch.predict``.

The same command line as the JAX package's predict CLI:
clip predictions with the configured algorithm and threshold, then frame
predictions at threshold 0.5, from one frame sweep, which prints the path
its forward took (``Serving forward: graphed (64x128x128x3: 1 eager, N
replayed)`` on the card). ``--device`` picks the
device (default ``cuda``; ``cpu`` runs the plain PyTorch path);
``--profile`` writes a ``torch.profiler`` trace under
``<PATHS.LOGS>/profiles``. ``PATHS.MODEL_TO_LOAD`` is a port checkpoint or a
Keras ``.h5`` / ``.onnx`` file (rebuilt from ``TRAIN.MODEL_DEF``). Under
``torchrun --nproc-per-node N`` each rank serves its rows of every batch
over the ``PARALLEL.MESH`` mesh and rank 0 writes the files.
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
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the prediction "
                        "pass to <PATHS.LOGS>/profiles")
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
    from ab_line_classifier_torch.parallel.mesh import run_with_env_group
    from ab_line_classifier_torch.utils.profiling import run_maybe_traced

    def run(device):
        # One restore and ONE frame sweep shared by both passes: thresholds
        # apply downstream of the probabilities.
        predictor = default_predictor(cfg, device)
        ds = FrameDataset(pd.read_csv(frames_path), frames_dir,
                          img_dim=cfg.img_dim)
        frame_probs = predictor.predict_dataset(ds)
        line = f"Serving forward: {predictor.graph_mode}"
        if predictor.graphed:
            line += " (" + ", ".join(
                f"{shape}: {s['eager_steps']} eager, {s['replays']} "
                f"replayed" for shape, s in predictor.summaries().items()
            ) + ")"
        print(line)
        compute_clip_predictions(
            cfg, frames_path, clips_path,
            class_thresh=float(
                cfg["CLIP_PREDICTION"]["CLASSIFICATION_THRESHOLD"]),
            clip_algorithm=cfg["CLIP_PREDICTION"]["ALGORITHM"],
            calculate_metrics=not args.no_metrics, predictor=predictor,
            frames_dir=frames_dir, frame_probs=frame_probs)
        compute_frame_predictions(cfg, frames_path, class_thresh=0.5,
                                  calculate_metrics=not args.no_metrics,
                                  predictor=predictor, frames_dir=frames_dir,
                                  frame_probs=frame_probs)

    run_with_env_group(
        lambda device: run_maybe_traced(lambda: run(device), args.profile,
                                        cfg), args.device)


if __name__ == "__main__":
    main()
