"""PyTorch port, test-set metrics without sklearn (``predict/metrics.py``):
``compute_metrics`` against the JAX package's (sklearn) on random sets
with ties in the probabilities (scores rounded to 1-3 decimals), sets of
one class, all-wrong and all-right predictions and a class map given in
another order: the same keys, the confusion matrix exactly, every other
value within 1e-12. ``roc_curve`` equals sklearn's curve point for point,
thresholds included. And the plots drawn from them exist.
"""

import warnings

import numpy as np
import pytest
from sklearn.metrics import roc_curve as sk_roc_curve

from ab_line_classifier_tpu.predict.metrics import (compute_metrics as
                                                    jax_compute_metrics)
from ab_line_classifier_torch.predict import metrics as M

CLASSES = ["a_lines", "b_lines"]


def case(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 80))
    kind = seed % 6
    labels = rng.randint(0, 2, n)
    if kind == 1:  # one class
        labels[:] = seed % 2
    p = np.round(rng.rand(n), int(rng.randint(1, 4))).astype(np.float32)
    if kind == 2:  # a perfect classifier
        p = np.where(labels == 1, 0.9, 0.1).astype(np.float32)
    if kind == 3:  # every prediction wrong
        p = np.where(labels == 1, 0.2, 0.8).astype(np.float32)
    probs = np.stack([1 - p, p], 1)
    return labels, (probs[:, 1] >= 0.5).astype(int), probs


def assert_same(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "confusion_matrix":
            assert got[k] == v
        else:
            assert isinstance(got[k], float)
            assert got[k] == pytest.approx(v, abs=1e-12, rel=0), k


@pytest.mark.parametrize("seeds", [range(0, 60), range(60, 120)])
def test_compute_metrics_matches_sklearn(seeds):
    for seed in seeds:
        labels, preds, probs = case(seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # sklearn: undefined metrics
            want = jax_compute_metrics(CLASSES, labels, preds, probs)
            want_no_probs = jax_compute_metrics(CLASSES, labels, preds)
        assert_same(M.compute_metrics(CLASSES, labels, preds, probs), want)
        assert_same(M.compute_metrics(CLASSES, labels, preds), want_no_probs)
        if len(np.unique(labels)) > 1:
            got = M.roc_curve(labels, probs[:, 1])
            want_curve = sk_roc_curve(labels, probs[:, 1])
            for g, w in zip(got, want_curve):
                np.testing.assert_array_equal(g, w)


def test_class_map_and_single_class_sets():
    labels = np.array([0, 0, 0, 0])
    preds = np.array([0, 1, 0, 0])
    probs = np.array([[0.9, 0.1], [0.3, 0.7], [0.6, 0.4], [0.8, 0.2]])
    idx = {"b_lines": 0, "a_lines": 1}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_compute_metrics(CLASSES, labels, preds, probs,
                                   class_idx_map=idx)
    got = M.compute_metrics(CLASSES, labels, preds, probs, class_idx_map=idx)
    assert_same(got, want)
    assert "macro_mean_auc" not in got  # AUC needs both classes
    assert got["confusion_matrix"] == [[3, 1], [0, 0]]
    with pytest.raises(ValueError, match="both classes"):
        M.roc_auc(labels, probs[:, 1])


def test_test_set_plots(tmp_path):
    from ab_line_classifier_torch.viz.visualization import (
        plot_confusion_matrix, plot_roc)

    labels, preds, probs = case(12)
    plot_roc("test", labels, probs, CLASSES, dir_path=str(tmp_path))
    plot_confusion_matrix(labels, preds, CLASSES, dir_path=str(tmp_path))
    one_class = np.zeros(5, int)
    plot_roc("single", one_class, probs[:5], CLASSES, dir_path=str(tmp_path))
    names = sorted(p.name.rsplit("_", 1)[0] for p in tmp_path.iterdir())
    assert names == ["cm", "roc_single", "roc_test"]
    assert all(p.stat().st_size > 1000 for p in tmp_path.iterdir())
    curves = M.roc_curves(labels, probs, CLASSES)
    assert [c[0] for c in curves] == CLASSES
    assert curves[1][3] == pytest.approx(M.roc_auc(labels, probs[:, 1]),
                                         abs=1e-15)
