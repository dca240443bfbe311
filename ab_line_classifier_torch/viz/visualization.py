"""Figures (port of the JAX package's ``viz/visualization.py``): the test
set's ROC curves and confusion matrix, the Grad-CAM heatmap panel, the
sweep plots (progress of a grid or random sweep, the GP's partial
dependence of a Bayesian one) and the clip-rule threshold experiments'
metric curves and ROC, written as timestamped PNGs with
the reference's file contract. Curves and matrices come from
``predict/metrics.py`` (numpy), not sklearn.

matplotlib is imported by the function that draws, with the ``Agg``
backend, so the package imports where matplotlib is not installed.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _ts() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, dir_path: Optional[str], name: str):
    """Write ``fig`` as ``<dir_path>/<name>_<timestamp>.png`` and close it,
    when ``dir_path`` is given. Returns the figure."""
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
        fig.savefig(os.path.join(dir_path, f"{name}_{_ts()}.png"), dpi=120)
        _pyplot().close(fig)
    return fig


def plot_roc(name: str, labels: np.ndarray, probs: np.ndarray,
             class_names: Sequence[str], dir_path: Optional[str] = None):
    """One-vs-rest ROC curve of each class with both outcomes present (JAX
    ``viz/visualization.py:34-57``); ``roc_<name>_<timestamp>.png``."""
    from ab_line_classifier_torch.predict.metrics import roc_curves

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    curves = roc_curves(labels, probs, class_names)
    for cname, fpr, tpr, area in curves:
        ax.plot(fpr, tpr, label=f"{cname} (AUC = {area:.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(f"ROC — {name}")
    if curves:
        ax.legend(loc="lower right")
    fig.tight_layout()
    return _save(fig, dir_path, f"roc_{name}")


def plot_confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                          class_names: Sequence[str],
                          dir_path: Optional[str] = None):
    """Confusion-matrix heatmap (JAX ``viz/visualization.py:62-84``);
    ``cm_<timestamp>.png``."""
    from ab_line_classifier_torch.predict.metrics import confusion_matrix

    plt = _pyplot()
    cm = confusion_matrix(labels, preds, len(class_names))
    fig, ax = plt.subplots(figsize=(5.5, 5))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(len(class_names)), class_names)
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    thresh = cm.max() / 2.0 if cm.max() else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    fig.colorbar(im)
    fig.tight_layout()
    return _save(fig, dir_path, "cm")


def visualize_heatmap(orig_img: np.ndarray, heatmap_img: np.ndarray,
                      img_filename: str, label: int, probs: np.ndarray,
                      class_names: Sequence[str],
                      dir_path: Optional[str] = None):
    """Side-by-side original / Grad-CAM panel with the true and predicted
    class in the title; saved as ``heatmap_<frame>_<timestamp>.png`` in
    ``dir_path`` (and the figure closed) when ``dir_path`` is given.
    Returns the matplotlib figure."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(orig_img.astype(np.uint8))
    axes[0].set_title("Original")
    axes[1].imshow(heatmap_img.astype(np.uint8))
    axes[1].set_title("Grad-CAM")
    for ax in axes:
        ax.axis("off")
    pred_idx = int(np.argmax(probs))
    fig.suptitle(
        f"{os.path.basename(img_filename)}  |  true: {class_names[label]}  "
        f"pred: {class_names[pred_idx]} "
        f"(p={float(np.max(probs)):.3f})")
    fig.tight_layout()
    base = os.path.splitext(os.path.basename(img_filename))[0]
    return _save(fig, dir_path, f"heatmap_{base}")


def plot_hparam_search(trials: List[Dict], objective_key: str = "objective",
                       goal: str = "maximize",
                       dir_path: Optional[str] = None):
    """Sweep progress: each trial's objective and the running best (JAX
    ``viz/visualization.py:117-138``); ``hparam_search_<timestamp>.png``.
    The serial sweep's objectives are signed to be maximized."""
    plt = _pyplot()
    objs = [t[objective_key] for t in trials]
    best = (np.maximum.accumulate(objs) if goal == "maximize"
            else np.minimum.accumulate(objs))
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(objs, "o-", label="trial objective")
    ax.plot(best, "r--", label="running best")
    ax.set_xlabel("Trial")
    ax.set_ylabel("Objective")
    ax.legend()
    fig.tight_layout()
    return _save(fig, dir_path, "hparam_search")


def plot_bayesian_hparam_opt(controller, dir_path: Optional[str] = None):
    """A Bayesian sweep's objective landscape (JAX
    ``viz/visualization.py:141-176``): per variable, the GP posterior
    mean's partial dependence, with the observed trials over it;
    ``bayes_opt_<timestamp>.png``. ``controller`` is a
    ``train.sweep.BayesController``."""
    plt = _pyplot()
    space = controller.space
    fig, axes = plt.subplots(1, len(space), figsize=(4.5 * len(space), 4),
                             squeeze=False)
    for ax, var in zip(axes[0], space):
        values, pd = controller.partial_dependence(var.name)
        xs = [p[var.name] for p, _ in controller.history]
        ys = [o for _, o in controller.history]
        if var.type == "set":
            pos = {val: i for i, val in enumerate(values)}
            ax.plot(range(len(values)), pd, "o-", label="GP partial dep.")
            ax.scatter([pos[x] for x in xs], ys, s=18, c="crimson",
                       alpha=0.6, label="trials")
            ax.set_xticks(range(len(values)), [str(v) for v in values])
        else:
            ax.plot(values, pd, "-", label="GP partial dep.")
            ax.scatter(xs, ys, s=18, c="crimson", alpha=0.6, label="trials")
            if var.type == "float_log":
                ax.set_xscale("log")
        ax.set_xlabel(var.name)
        ax.set_ylabel("objective")
    axes[0][0].legend(loc="best", fontsize=8)
    fig.suptitle("Bayesian hyperparameter search — GP partial dependence")
    fig.tight_layout()
    return _save(fig, dir_path, "bayes_opt")


def plot_b_line_threshold_experiment(metrics_rows: Sequence[Dict], min_t: int,
                                     max_t: int, threshold_col: str,
                                     class_thresh: float,
                                     dir_path: Optional[str] = None):
    """Clip metrics across B-line count thresholds or window lengths (JAX
    ``viz/visualization.py:179-202``); ``metrics_rows`` are
    ``predict/experiments.py``'s table rows;
    ``threshold_exp_<timestamp>.png``."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 5))
    xs = [row[threshold_col] for row in metrics_rows]
    for col in ("precision", "recall", "specificity", "f1", "accuracy"):
        if metrics_rows and col in metrics_rows[0]:
            ax.plot(xs, [row[col] for row in metrics_rows], "o-", label=col)
    ax.set_xlabel(threshold_col)
    ax.set_ylabel("Metric value")
    ax.set_title(f"Clip metrics vs {threshold_col} "
                 f"(frame threshold {class_thresh})")
    ax.legend()
    fig.tight_layout()
    return _save(fig, dir_path, "threshold_exp")


def plot_b_line_threshold_roc_curve(tprs: Sequence[float],
                                    fprs: Sequence[float],
                                    dir_path: Optional[str] = None):
    """ROC over count thresholds with its trapezoid AUC (JAX
    ``viz/visualization.py:205-228``); ``threshold_roc_<timestamp>.png``."""
    plt = _pyplot()
    order = np.argsort(fprs)
    f = np.asarray(fprs)[order]
    t = np.asarray(tprs)[order]
    area = float(np.trapezoid(t, f)) if len(f) > 1 else 0.0
    fig, ax = plt.subplots(figsize=(6, 5.5))
    ax.plot(f, t, "o-", label=f"AUC = {area:.3f}")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.legend()
    fig.tight_layout()
    return _save(fig, dir_path, "threshold_roc")
