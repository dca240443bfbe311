"""Offline clip-rule experiments over saved frame predictions (port of the
JAX package's ``predict/experiments.py``; the reference's
``src/predict.py:225-272, 310-423``).

The experiments sweep the clip-level decision rule (a count of B-line
frames, contiguous or in total, or a sliding window's length) over a
frame-prediction CSV and write metrics tables; the WaveBase rule reads the
probe's own framewise CSVs. They choose the thresholds deploy serving
uses.

Nothing here needs pandas: CSVs are read and written as pandas does by
``utils/tables.py`` (pandas' own float parser included). The per-clip
statistics run on the
device through ``ops/clip_aggregation.py``, the metrics through
``predict/metrics.py``. Every table and CSV is the JAX package's, byte for
byte.
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ab_line_classifier_torch import resolve_device
from ab_line_classifier_torch.config import Config
from ab_line_classifier_torch.ops import clip_aggregation as agg
from ab_line_classifier_torch.predict.metrics import compute_metrics
from ab_line_classifier_torch.predict.predict import load_class_idx_map
from ab_line_classifier_torch.utils.tables import (Table, is_na, read_table,
                                                   write_csv, write_table)
from ab_line_classifier_torch.viz.visualization import (
    plot_b_line_threshold_experiment, plot_b_line_threshold_roc_curve)

CLIP = "Clip"
PRED_CLASS = "Pred Class"
CLASS_NUM = "Class"
B_PROB = "b_lines"
A_PROB = "a_lines"
B_LINE_THRESHOLD = "B-line Threshold"
SLIDING_WINDOW = "Sliding Window Length"


def _ts() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def flatten_metrics(m: Dict, sep: str = "_", prefix: str = "") -> Dict:
    """``pd.json_normalize(m, sep=sep)``'s one row: nested dicts joined by
    ``sep``; lists kept as values."""
    out = {}
    for k, v in m.items():
        key = f"{prefix}{sep}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_metrics(v, sep, key))
        else:
            out[key] = v
    return out


def _clip_groups(table: Table) -> Tuple[List[str], np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
    """Frame rows -> sorted clip names, padded ``[n_clips, T]`` float32
    B-line probabilities and frame mask, clip labels (a clip's largest
    ``Class``), and each row's clip (``Frame Path`` up to its last
    underscore)."""
    clips = np.array([str(p).rpartition("_")[0] for p in table["Frame Path"]],
                     object)
    names = sorted(set(clips))
    rows = [np.nonzero(clips == name)[0] for name in names]
    max_t = max(len(r) for r in rows)
    b_probs = np.zeros((len(names), max_t), np.float32)
    mask = np.zeros((len(names), max_t), np.float32)
    labels = np.zeros(len(names), np.int64)
    for i, r in enumerate(rows):
        b_probs[i, :len(r)] = table[B_PROB][r]
        mask[i, :len(r)] = 1.0
        labels[i] = table[CLASS_NUM][r].max()
    return names, b_probs, mask, labels, clips


def b_line_threshold_experiment(cfg: Config, frame_preds_path: str,
                                min_b_lines: int, max_b_lines: int,
                                class_thresh: float = 0.5,
                                contiguous: bool = True,
                                document: bool = False,
                                device=None) -> List[Dict]:
    """Vary the count of predicted-B-line frames that calls a clip
    pathological (JAX ``predict/experiments.py:58-118``). Returns the
    metrics table's rows, one per threshold; writes ``preds.csv`` (the
    frame table with ``Clip`` and ``Pred Class``) and, with ``document``,
    the metrics and per-clip CSVs and plots."""
    dev = resolve_device(device)
    table = read_table(frame_preds_path)
    names, b_probs, mask, labels, clips = _clip_groups(table)
    frame_pos = (torch.from_numpy(b_probs).to(dev) >= class_thresh).to(
        torch.int32)
    mask_t = torch.from_numpy(mask).to(dev)
    if contiguous:
        n_b_col = "Contiguous Predicted B-lines"
        counts = agg.max_contiguous_positive(frame_pos, mask_t).cpu().numpy()
    else:
        n_b_col = "Total Predicted B-lines"
        counts = (frame_pos * mask_t.to(torch.int32)).sum(dim=1).to(
            torch.int64).cpu().numpy()

    out = dict(table)
    out[CLIP] = clips
    out[PRED_CLASS] = (table[B_PROB] >= class_thresh).astype(np.int64)
    exp_dir = cfg["PATHS"]["EXPERIMENTS"]
    os.makedirs(exp_dir, exist_ok=True)
    write_table(os.path.join(exp_dir, "preds.csv"), out)

    idx_map = load_class_idx_map(cfg)
    rows, tprs, fprs = [], [], []
    for threshold in range(min_b_lines, max_b_lines + 1):
        clip_preds = (counts >= threshold).astype(int)
        m = compute_metrics(cfg.classes, labels, clip_preds,
                            class_idx_map=idx_map)
        rows.append({B_LINE_THRESHOLD: threshold, **flatten_metrics(m)})
        tprs.append(m["recall"])
        fprs.append(1.0 - m["specificity"])

    if document:
        viz_dir = cfg["PATHS"]["EXPERIMENT_VISUALIZATIONS"]
        _plot(plot_b_line_threshold_experiment, rows, min_b_lines,
              max_b_lines, B_LINE_THRESHOLD, class_thresh, dir_path=viz_dir)
        write_csv(os.path.join(exp_dir, f"b-line_thresholds_{_ts()}.csv"),
                  rows)
        write_table(os.path.join(exp_dir,
                                 f"clip_contiguous_preds_{_ts()}.csv"),
                    {CLIP: names, CLASS_NUM: labels, n_b_col: counts},
                    index=True)
        _plot(plot_b_line_threshold_roc_curve, tprs, fprs,
              dir_path=viz_dir)
    return rows


def sliding_window_variation_experiment(cfg: Config, frame_preds_path: str,
                                        min_window_length: int,
                                        max_window_length: int,
                                        class_thresh: float = 0.5,
                                        document: bool = False,
                                        device=None) -> List[Dict]:
    """Vary the averaging window of the highest-contiguous-mean rule (JAX
    ``predict/experiments.py:121-168``). Returns the metrics table's rows;
    with ``document`` writes it, the last window's per-clip probabilities
    and the plot."""
    dev = resolve_device(device)
    names, b_probs, mask, labels, _ = _clip_groups(
        read_table(frame_preds_path))
    probs3 = torch.from_numpy(np.stack([1.0 - b_probs, b_probs],
                                       axis=-1)).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)

    idx_map = load_class_idx_map(cfg)
    rows, last_clips = [], None
    for window in range(min_window_length, max_window_length + 1):
        clip_probs = agg.sliding_window_clip_probs(probs3, window,
                                                   mask_t).cpu().numpy()
        clip_preds = (clip_probs[:, 1] >= class_thresh).astype(int)
        m = compute_metrics(cfg.classes, labels, clip_preds, clip_probs,
                            class_idx_map=idx_map)
        rows.append({SLIDING_WINDOW: window, **flatten_metrics(m)})
        last_clips = {CLIP: names, CLASS_NUM: labels,
                      B_PROB: clip_probs[:, 1], A_PROB: clip_probs[:, 0]}

    if document:
        exp_dir = cfg["PATHS"]["EXPERIMENTS"]
        os.makedirs(exp_dir, exist_ok=True)
        _plot(plot_b_line_threshold_experiment, rows, min_window_length,
              max_window_length, SLIDING_WINDOW, class_thresh,
              dir_path=cfg["PATHS"]["EXPERIMENT_VISUALIZATIONS"])
        write_csv(os.path.join(
            exp_dir, f"sliding_window_exp_c{class_thresh}_{_ts()}.csv"), rows)
        write_table(os.path.join(
            exp_dir,
            f"clip_sliding_window_preds_c{class_thresh}_{_ts()}.csv"),
            last_clips, index=True)
    return rows


def _plot(draw, *args, **kwargs) -> None:
    """``draw(*args, **kwargs)``; a missing matplotlib skips the plot with a
    notice."""
    try:
        draw(*args, **kwargs)
    except ImportError as e:
        print(f"(plotting skipped: {e})")


def predict_clipwise_with_contiguity_threshold_wb(
        preds: Sequence[Sequence[str]], target_class: str,
        contiguity_threshold: int, classification_threshold: float) -> bool:
    """The WaveBase CSV contiguity rule (JAX
    ``predict/experiments.py:171-183``): rows of (class name, probability
    string); true once ``contiguity_threshold`` consecutive rows name
    ``target_class`` with a probability strictly above the threshold."""
    cur = 0
    for row in preds:
        cls = row[0] if row else ""
        prob = row[1] if len(row) > 1 else ""
        if (cls == target_class and not is_na(prob)
                and float(prob) > classification_threshold):
            cur += 1
        else:
            cur = 0
        if cur >= contiguity_threshold:
            return True
    return False


def compute_clip_predictions_wb(cfg: Config,
                                target_class: str = "B-Lines"
                                ) -> List[Tuple[str, str]]:
    """Clip predictions from the WaveBase-exported framewise CSVs under
    ``RT_ROOT_DIR/<date>/recordings/`` (JAX
    ``predict/experiments.py:186-205``): ``(filename, prediction)`` rows,
    also written to ``BATCH_PREDS``."""
    rootdir = cfg["PATHS"]["RT_ROOT_DIR"]
    res = []
    dated_dirs = next(os.walk(rootdir))[1] if os.path.isdir(rootdir) else []
    for dated_dir in dated_dirs:
        rec_root = os.path.join(rootdir, dated_dir, "recordings")
        for root, _, files in os.walk(rec_root):
            for name in [f for f in files if ".csv" in f]:
                with open(os.path.join(root, name), newline="") as f:
                    data = list(csv.reader(f))
                positive = predict_clipwise_with_contiguity_threshold_wb(
                    data, target_class,
                    int(cfg["CLIP_PREDICTION"]["CONTIGUITY_THRESHOLD"]),
                    float(cfg["CLIP_PREDICTION"]["CLASSIFICATION_THRESHOLD"]))
                res.append((name.replace("_probs.csv", ".mkv"),
                            "B-Line" if positive else "A-Line"))
    os.makedirs(cfg["PATHS"]["BATCH_PREDS"], exist_ok=True)
    ct = cfg["CLIP_PREDICTION"]["CONTIGUITY_THRESHOLD"]
    thresh_str = str(cfg["CLIP_PREDICTION"]["CLASSIFICATION_THRESHOLD"])
    tag = thresh_str[2] if len(thresh_str) > 2 else "0"
    write_table(os.path.join(
        cfg["PATHS"]["BATCH_PREDS"],
        f"{os.path.basename(os.path.normpath(rootdir))}_clip_predictions_"
        f"T{ct}_t0{tag}_{_ts()}.csv"),
        {"filename": [r[0] for r in res], "prediction": [r[1] for r in res]})
    return res
