"""PyTorch port, the quickstart (``python -m
ab_line_classifier_torch.quickstart``): run as a new user runs it (a fresh
subprocess from the repository root), on the CPU, and held to the
artifact contract of the JAX package's quickstart
(``tests/test_quickstart_example.py``): the workspace config, a trained
checkpoint, frame and clip prediction CSVs and metrics JSONs, and the
Grad-CAM heatmap PNGs of the 3 requested frames.
"""

import glob
import os
import subprocess
import sys

from conftest import REPO_ROOT, cli_env


def test_quickstart_runs_end_to_end_on_the_cpu(tmp_path):
    ws = str(tmp_path / "qs_ws")
    proc = subprocess.run(
        [sys.executable, "-m", "ab_line_classifier_torch.quickstart",
         "--workspace", ws, "--epochs", "2", "--device", "cpu"],
        env=cli_env(), cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Done." in proc.stdout

    assert os.path.isfile(os.path.join(ws, "config.yml"))
    ckpts = glob.glob(os.path.join(ws, "results", "models", "model*"))
    assert ckpts and any(
        os.path.isfile(os.path.join(c, "meta.json")) for c in ckpts)
    preds = glob.glob(os.path.join(ws, "results", "predictions", "*.csv"))
    assert {"clips", "frames"} <= {os.path.basename(p).split("_")[1]
                                   for p in preds}
    assert glob.glob(os.path.join(ws, "results", "metrics", "*.json"))
    assert len(glob.glob(os.path.join(ws, "img", "heatmaps", "*.png"))) == 3
