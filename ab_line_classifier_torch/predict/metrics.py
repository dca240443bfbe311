"""Test-set metrics in numpy (the JAX package's ``predict/metrics.py``
computes them with sklearn; these give the same numbers, the same dict
keys and the same JSON files, where sklearn is not installed).

``compute_metrics`` matches the reference's (reference
``src/predict.py:89-122``): confusion matrix, binary precision, recall
(sensitivity, the positive class's recall), specificity (the negative
class's), F1, accuracy, and with probabilities macro / weighted AUC and
one AUC per class. ``roc_curve`` and ``auc`` follow sklearn's
``roc_curve`` (thresholds at each distinct score, collinear points
dropped, the curve started at (0, 0)) and ``auc`` (the trapezoid rule),
so the areas agree with sklearn's to float64 rounding, ties in the scores
included.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     n_classes: int) -> np.ndarray:
    """``[n_classes, n_classes]`` counts, rows true class, columns
    predicted."""
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (np.asarray(labels, np.int64), np.asarray(preds, np.int64)),
              1)
    return cm


def roc_curve(y_true: np.ndarray, y_score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(fpr, tpr, thresholds)`` of binary labels (1 positive) against
    scores, as sklearn's ``roc_curve`` with ``drop_intermediate``."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    order = np.argsort(-y_score.astype(np.float64), kind="stable")
    y_score, y_true = y_score[order], y_true[order]
    # The last position of each run of equal scores.
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true.astype(np.float64))[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = y_score[idx].astype(np.float64)
    if len(fps) > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                    np.diff(tps, 2)),
                                True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, np.r_[np.inf, thresholds]


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Area under a monotone curve by the trapezoid rule."""
    dx = np.diff(x)
    direction = -1 if np.any(dx < 0) and np.all(dx <= 0) else 1
    if np.any(dx < 0) and direction == 1:
        raise ValueError(f"x is neither increasing nor decreasing: {x}")
    return float(direction * np.trapezoid(y, x))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC AUC (both classes must be present)."""
    if len(np.unique(y_true)) != 2:
        raise ValueError("ROC AUC needs both classes in y_true")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def _divide(num: float, den: float) -> float:
    """``num / den``, 0 where ``den`` is 0 (sklearn's zero_division=0)."""
    return float(num / den) if den else 0.0


def compute_metrics(class_names: Sequence[str], labels: np.ndarray,
                    preds: np.ndarray,
                    probs: Optional[np.ndarray] = None,
                    class_idx_map: Optional[Dict[str, int]] = None) -> Dict:
    """:param class_idx_map: class name -> column index (the reference's
    pickled CLASS_NAME_MAP); defaults to ``class_names`` order."""
    class_names = list(class_names)
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    idx_map = class_idx_map or {c: i for i, c in enumerate(class_names)}
    cm = confusion_matrix(labels, preds, len(class_names))
    # Binary precision and F1 of class 1; recall of every class.
    tp = float(cm[1, 1])
    true_sum, pred_sum = cm.sum(1), cm.sum(0)
    recalls = [_divide(cm[i, i], true_sum[i]) for i in range(len(cm))]

    metrics: Dict = {"confusion_matrix": cm.tolist(),
                     "precision": _divide(tp, pred_sum[1]),
                     "recall": recalls[idx_map["b_lines"]],
                     "specificity": recalls[idx_map["a_lines"]],
                     "f1": _divide(2 * tp, true_sum[1] + pred_sum[1]),
                     "accuracy": float(np.mean(labels == preds))}
    if probs is not None and len(np.unique(labels)) > 1:
        probs = np.asarray(probs)
        # A binary AUC: sklearn's macro and weighted averages both reduce
        # to it.
        metrics["macro_mean_auc"] = roc_auc(labels, probs[:, 1])
        metrics["weighted_mean_auc"] = metrics["macro_mean_auc"]
        for i, class_name in enumerate(class_names):
            metrics[class_name + "_auc"] = roc_auc(
                (labels == i).astype(int), probs[:, i])
    return metrics


def roc_curves(labels: np.ndarray, probs: np.ndarray,
               class_names: Sequence[str]) -> List[Tuple]:
    """One ``(class_name, fpr, tpr, auc)`` per class present with both
    outcomes in ``labels`` (one-vs-rest on its probability column)."""
    labels = np.asarray(labels)
    out = []
    for i, cname in enumerate(class_names):
        y_true = (labels == i).astype(int)
        if len(np.unique(y_true)) < 2:
            continue
        fpr, tpr, _ = roc_curve(y_true, np.asarray(probs)[:, i])
        out.append((cname, fpr, tpr, auc(fpr, tpr)))
    return out
