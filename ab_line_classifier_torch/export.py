"""CLI entry point: ``python -m ab_line_classifier_torch.export`` (port of
the JAX package's ``export.py``, ``ablc-export``).

Exports a trained checkpoint to a standard ONNX file, the outbound half of
the reference's deployment workflow (its WaveBase device serves ``.onnx``;
the reference made those files with an external keras -> tf2onnx step).

    python -m ab_line_classifier_torch.export --model <checkpoint> \\
        --out model.onnx --batch-size 1 [--config config.yml] [--device cpu]

Any checkpoint ``Predictor.restore`` takes exports: a port checkpoint
directory, a Keras ``.h5`` or an ``.onnx`` (re-stamping one). The restore
runs on ``--device`` (default cuda); the exported graph takes preprocessed
float32 ``[batch, H, W, 3]`` input and holds the float32 weights the
checkpoint restored (a mixed-precision model's master weights).
"""

from __future__ import annotations

import argparse
import sys


def export_checkpoint(model_path: str, out_path: str, *,
                      batch_size: int = 1, cfg=None, device=None) -> None:
    """Restore ``model_path`` (``cfg`` rebuilds the architecture of a
    ``.h5`` / ``.onnx``) on ``device`` (default cuda) and export it to
    ``out_path``."""
    from ab_line_classifier_torch.models.onnx_export import export_onnx
    from ab_line_classifier_torch.predict.predict import Predictor

    predictor = Predictor.restore(model_path, cfg=cfg, device=device)
    export_onnx(predictor.spec, predictor.weights, out_path,
                batch_size=batch_size)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Export a trained checkpoint to ONNX")
    p.add_argument("--config", default=None, help="path to config.yml")
    p.add_argument("--model", default=None,
                   help="checkpoint path (default: PATHS.MODEL_TO_LOAD)")
    p.add_argument("--out", required=True, help="output .onnx path")
    p.add_argument("--batch-size", type=int, default=1,
                   help="static batch dim of the exported graph")
    p.add_argument("--device", default="cuda",
                   help="device the checkpoint is restored on")
    args = p.parse_args(argv)

    from ab_line_classifier_torch.config import load_config

    cfg = load_config(args.config)
    model_path = args.model or cfg["PATHS"]["MODEL_TO_LOAD"]
    export_checkpoint(model_path, args.out, batch_size=args.batch_size,
                      cfg=cfg, device=args.device)
    print(f"exported {model_path} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
