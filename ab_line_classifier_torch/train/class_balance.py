"""Class-imbalance handling (a copy of the JAX package's
``train/class_balance.py``): loss weights and the output-bias prior.

* class weights ``w_i = (1 / n_classes) * N / n_i`` from the training
  set's class histogram;
* output bias: the per-class log-odds prior ``log(n_i / (N - n_i))`` that
  initializes the final Dense bias.

Each takes a frames table (its ``Class`` column) or a label vector. The
``*_array`` forms are the fixed-width ``[C]`` vectors of the
trial-parallel trainers, a class absent from a fold counted as 1 so that
both stay finite.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _labels(train, class_key: str) -> np.ndarray:
    if isinstance(train, np.ndarray):
        return train.astype(int)
    return train[class_key].to_numpy().astype(int)


def class_histogram(train, class_key: str = "Class") -> np.ndarray:
    return np.bincount(_labels(train, class_key))


def compute_class_weight(train, class_key: str = "Class") -> Dict[int, float]:
    hist = class_histogram(train, class_key)
    total = hist.sum()
    n = len(hist)
    return {i: float((1.0 / n) * total / hist[i]) for i in range(n)}


def compute_output_bias(train, class_key: str = "Class") -> np.ndarray:
    hist = class_histogram(train, class_key).astype(np.float64)
    total = hist.sum()
    return np.log(hist / (total - hist)).astype(np.float32)


def class_weight_array(train, n_classes: int,
                       class_key: str = "Class") -> np.ndarray:
    """:func:`compute_class_weight` as a float32 ``[n_classes]`` vector."""
    hist = np.bincount(_labels(train, class_key),
                       minlength=n_classes).astype(np.float64)
    total = hist.sum()
    return ((1.0 / n_classes) * total
            / np.maximum(hist, 1)).astype(np.float32)


def output_bias_array(train, n_classes: int,
                      class_key: str = "Class") -> np.ndarray:
    """:func:`compute_output_bias` as a float32 ``[n_classes]`` vector: the
    total over the raw counts, each class's count at least 1."""
    hist = np.bincount(_labels(train, class_key),
                       minlength=n_classes).astype(np.float64)
    total = hist.sum()
    hist = np.maximum(hist, 1.0)
    return np.log(hist / np.maximum(total - hist, 1.0)).astype(np.float32)
