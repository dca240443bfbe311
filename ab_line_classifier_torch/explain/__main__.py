"""CLI entry point: ``python -m ab_line_classifier_torch.explain``.

The JAX package's explain CLI on the port: Grad-CAM heatmap PNGs for the
frames named on the command line (matched by file name), or for the first
``--limit`` frames of the frames table, into ``PATHS.HEATMAPS``. ``--device``
picks the device (default ``cuda``; ``cpu`` runs the plain PyTorch path),
``--profile`` writes a ``torch.profiler`` trace under
``<PATHS.LOGS>/profiles``. The frames go in batches of up to 32, one CUDA
graph per batch shape on the card (replayed from the shape's second
batch); the CLI prints the path the pass took (``graphed`` or
``uncaptured``). Under ``torchrun`` every rank runs the pass (the JAX
package's Grad-CAM has no mesh) and rank 0 writes the PNGs.
"""

import argparse
import os

from ab_line_classifier_torch.config import load_config


def main():
    p = argparse.ArgumentParser(description="Grad-CAM heatmaps")
    p.add_argument("--config", default=None, help="path to config.yml")
    p.add_argument("--frames", nargs="*", default=None,
                   help="frame filenames to explain (default: the first "
                        "--limit frames of the frame table)")
    p.add_argument("--mode", choices=["normal", "plusplus"], default=None)
    p.add_argument("--limit", type=int, default=8)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to explain on (default cuda; there is no "
                        "silent fallback to the CPU)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the explain pass "
                        "to <PATHS.LOGS>/profiles")
    args = p.parse_args()

    import pandas as pd

    from ab_line_classifier_torch.explain.gradcam import GradCAMExplainer
    from ab_line_classifier_torch.parallel.mesh import (is_main,
                                                        run_with_env_group)
    from ab_line_classifier_torch.utils.profiling import run_maybe_traced

    cfg = load_config(args.config)
    frame_df = pd.read_csv(cfg["PATHS"]["FRAME_TABLE"])
    if args.frames:
        # The table stores bare file names; full or relative paths match by
        # their base name.
        wanted = {os.path.basename(f) for f in args.frames}
        frame_df = frame_df[frame_df["Frame Path"].map(os.path.basename)
                            .isin(wanted)]
        if frame_df.empty:
            raise SystemExit(
                f"none of {sorted(wanted)} found in the frame table "
                f"({cfg['PATHS']['FRAME_TABLE']})")
    else:
        frame_df = frame_df.head(args.limit)
    frame_df = frame_df.reset_index(drop=True)

    def run(device):
        explainer = GradCAMExplainer(cfg, mode=args.mode, device=device)
        run_maybe_traced(lambda: explainer.apply_gradcam(frame_df),
                         args.profile, cfg)
        fused = explainer.fused
        line = f"Grad-CAM pass: {fused.graph_mode}"
        if fused.graphed:
            line += " (" + ", ".join(
                f"{shape}: {s['eager_steps']} eager, {s['replays']} "
                f"replayed" for shape, s in fused.summaries().items()) + ")"
        print(line)
        if is_main():
            print(f"wrote {len(frame_df)} heatmaps to "
                  f"{cfg['PATHS']['HEATMAPS']}")

    run_with_env_group(run, args.device)


if __name__ == "__main__":
    main()
