"""PyTorch port, streamed training metrics: ``ops/metrics.py`` against the
JAX package's on fuzzed masked batches: accuracy, the binned AUC (200
thresholds, Keras placement), per-class precision / recall at 1/n_classes
and the loss mean, accumulated over three batches. Some probabilities sit
exactly on a threshold, where the comparisons' half-open sides decide the
bin. The counts are sums of 0/1 products (exact in float32), so the
metrics agree within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ab_line_classifier_tpu.ops import metrics as jax_M
from ab_line_classifier_torch.ops import metrics as M


def batch(rng, b, c):
    logits = rng.normal(0, 2, (b, c))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if c == 2:
        # A few rows exactly on thresholds (k / 199 in float32).
        on = rng.rand(b) < 0.2
        th = (rng.randint(1, 199, b) / 199).astype(np.float32)
        probs[on, 1] = th[on]
        probs[on, 0] = 1 - th[on]
    labels = rng.randint(0, c, b)
    mask = (rng.rand(b) < 0.8).astype(np.float32)
    loss = rng.exponential(1.0, b).astype(np.float32)
    return probs.astype(np.float32), labels.astype(np.int32), mask, loss


@pytest.mark.parametrize("n_classes,one_hot,seed",
                         [(2, False, 0), (2, True, 1), (3, False, 2),
                          (3, True, 3)])
def test_streamed_metrics_match_jax(n_classes, one_hot, seed):
    rng = np.random.RandomState(seed)
    js = jax_M.init_metrics(n_classes)
    ts = M.init_metrics(n_classes)
    for b in (16, 7, 33):
        probs, labels, mask, loss = batch(rng, b, n_classes)
        lab = np.eye(n_classes, dtype=np.float32)[labels] if one_hot \
            else labels
        js = jax_M.update_metrics(js, jnp.asarray(probs), jnp.asarray(lab),
                                  loss=jnp.asarray(loss),
                                  sample_mask=jnp.asarray(mask))
        M.update_metrics(ts, torch.from_numpy(probs), torch.from_numpy(lab),
                         loss=torch.from_numpy(loss),
                         sample_mask=torch.from_numpy(mask))
    names = ["a_lines", "b_lines", "other"][:n_classes]
    want = {k: float(v) for k, v in jax_M.compute_metrics(js, names).items()}
    got = M.compute_metrics(ts, names)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    for field in ("auc_tp", "auc_fp", "auc_tn", "auc_fn", "cls_tp"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)))


def test_thresholds_match_keras_placement():
    np.testing.assert_array_equal(M.auc_thresholds(200).numpy(),
                                  np.asarray(jax_M.auc_thresholds(200)))
