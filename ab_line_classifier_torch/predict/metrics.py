"""Exact evaluation metrics (port of
the JAX package's ``predict/metrics.py``; sklearn is imported only
when metrics are computed), matching the reference's
``compute_metrics`` (reference ``src/predict.py:89-122``): confusion matrix,
binary precision, recall (sensitivity = positive-class recall), specificity
(negative-class recall), F1, accuracy, macro/weighted AUC and classwise AUCs,
with the same dict keys so metrics JSON files are schema-identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def compute_metrics(class_names: List[str], labels: np.ndarray,
                    preds: np.ndarray,
                    probs: Optional[np.ndarray] = None,
                    class_idx_map: Optional[Dict[str, int]] = None) -> Dict:
    """:param class_idx_map: class name -> column index (the reference's
    pickled CLASS_NAME_MAP, predict.py:31); defaults to ``class_names``
    order."""
    from sklearn.metrics import (accuracy_score, confusion_matrix, f1_score,
                                 precision_score, recall_score,
                                 roc_auc_score)

    labels = np.asarray(labels)
    preds = np.asarray(preds)
    idx_map = class_idx_map or {c: i for i, c in enumerate(class_names)}

    metrics: Dict = {}
    precision = precision_score(labels, preds, average="binary",
                                zero_division=0)
    recalls = recall_score(labels, preds, average=None, zero_division=0,
                           labels=list(range(len(class_names))))
    f1 = f1_score(labels, preds, average="binary", zero_division=0)

    metrics["confusion_matrix"] = confusion_matrix(
        labels, preds, labels=list(range(len(class_names)))).tolist()
    metrics["precision"] = float(precision)
    # Recall of the positive class (sensitivity) / negative class (specificity)
    metrics["recall"] = float(recalls[idx_map["b_lines"]])
    metrics["specificity"] = float(recalls[idx_map["a_lines"]])
    metrics["f1"] = float(f1)
    metrics["accuracy"] = float(accuracy_score(labels, preds))

    if probs is not None and len(np.unique(labels)) > 1:
        probs = np.asarray(probs)
        metrics["macro_mean_auc"] = float(roc_auc_score(
            labels, probs[:, 1], average="macro", multi_class="ovr"))
        metrics["weighted_mean_auc"] = float(roc_auc_score(
            labels, probs[:, 1], average="weighted", multi_class="ovr"))
        for class_name in class_names:
            classwise_labels = (labels == class_names.index(class_name)).astype(int)
            class_probs = probs[:, class_names.index(class_name)]
            metrics[class_name + "_auc"] = float(
                roc_auc_score(classwise_labels, class_probs))
    return metrics
