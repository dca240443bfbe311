"""Streamed training metrics (port of the JAX package's ``ops/metrics.py``).

Keras's training metrics: accuracy, the binned AUC (200 thresholds,
micro-averaged over every class column of the softmax output, trapezoid
over the binned ROC points, exactly as ``tf.keras.metrics.AUC``) and
per-class precision / recall at threshold ``1 / n_classes``.
:class:`MetricsState` holds only sums (confusion counts per threshold bin,
correct counts, loss totals), so a batch updates it on the device inside
the step, and :func:`compute_metrics` finalizes it to floats at the end of
an epoch. With ``trials``, the state has a leading trial axis and
:func:`update_stacked_metrics` accumulates a stacked batch ``[F, B, C]``
of all trials at once (the trial-parallel trainer's).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

_EPS = 1e-7


@dataclasses.dataclass
class MetricsState:
    """Additive accumulators on one device: ``auc_*`` ``[n_thresholds]``,
    ``cls_*`` ``[n_classes]``, the rest scalars; all float32."""

    n: torch.Tensor
    correct: torch.Tensor
    loss_sum: torch.Tensor
    auc_tp: torch.Tensor
    auc_fp: torch.Tensor
    auc_tn: torch.Tensor
    auc_fn: torch.Tensor
    cls_tp: torch.Tensor
    cls_fp: torch.Tensor
    cls_fn: torch.Tensor


def auc_thresholds(num_thresholds: int = 200, device=None) -> torch.Tensor:
    """Keras AUC threshold placement: ``num_thresholds - 2`` interior points
    plus ``-eps`` and ``1 + eps``."""
    inner = (torch.arange(1, num_thresholds - 1, dtype=torch.float32,
                          device=device) / (num_thresholds - 1))

    def end(v):  # made on the device: no host-to-device copy per batch
        return torch.full((1,), v, dtype=torch.float32, device=device)
    return torch.cat([end(-_EPS), inner, end(1.0 + _EPS)])


def init_metrics(n_classes: int, num_thresholds: int = 200,
                 device=None, trials: Optional[int] = None) -> MetricsState:
    """Zero accumulators; with ``trials``, each with a leading axis of
    that many trials."""
    lead = () if trials is None else (trials,)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)
    return MetricsState(n=z(), correct=z(), loss_sum=z(),
                        auc_tp=z(num_thresholds), auc_fp=z(num_thresholds),
                        auc_tn=z(num_thresholds), auc_fn=z(num_thresholds),
                        cls_tp=z(n_classes), cls_fp=z(n_classes),
                        cls_fn=z(n_classes))


def one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """float32 one-hot rows of integer ``labels`` (``F.one_hot`` would read
    the labels back to check their range: a device sync per batch)."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.long()[:, None] == classes).to(torch.float32)


@torch.no_grad()
def update_metrics(state: MetricsState, probs: torch.Tensor,
                   labels: torch.Tensor, loss: Optional[torch.Tensor] = None,
                   sample_mask: Optional[torch.Tensor] = None) -> None:
    """Accumulate a batch into ``state`` in place: ``probs`` ``[B, C]``
    softmax probabilities, ``labels`` ``[B, C]`` one-hot (or ``[B]``
    integer), ``loss`` ``[B]`` per-example values, ``sample_mask`` ``[B]``
    (0 marks padding rows)."""
    probs = probs.to(torch.float32)
    n_classes = probs.shape[-1]
    if labels.ndim == probs.ndim - 1:
        labels = one_hot(labels, n_classes)
    labels = labels.to(torch.float32)
    m = (torch.ones(probs.shape[0], device=probs.device)
         if sample_mask is None else sample_mask.to(torch.float32))

    correct = ((probs.argmax(-1) == labels.argmax(-1)) * m).sum()

    th = auc_thresholds(state.auc_tp.shape[0], probs.device)
    p_flat = probs.reshape(-1)
    y_flat = labels.reshape(-1)
    m_flat = m.repeat_interleave(n_classes)
    pred_pos = (p_flat[None, :] > th[:, None]).to(torch.float32)
    w_pos = y_flat * m_flat
    w_neg = (1.0 - y_flat) * m_flat
    tp = pred_pos @ w_pos
    fp = pred_pos @ w_neg

    cls_pred = (probs > 1.0 / n_classes).to(torch.float32) * m[:, None]
    state.n += m.sum()
    state.correct += correct
    if loss is not None:
        state.loss_sum += (loss.to(torch.float32) * m).sum()
    state.auc_tp += tp
    state.auc_fp += fp
    state.auc_fn += w_pos.sum() - tp
    state.auc_tn += w_neg.sum() - fp
    state.cls_tp += (cls_pred * labels).sum(0)
    state.cls_fp += (cls_pred * (1.0 - labels)).sum(0)
    state.cls_fn += ((1.0 - cls_pred) * labels * m[:, None]).sum(0)


@torch.no_grad()
def update_stacked_metrics(state: MetricsState, probs: torch.Tensor,
                           labels: torch.Tensor, loss: torch.Tensor,
                           sample_mask: torch.Tensor) -> None:
    """:func:`update_metrics` for F trials at once, one launch per op:
    ``state`` from ``init_metrics(..., trials=F)``, ``probs`` and
    ``labels`` (one-hot) ``[F, B, C]``, ``loss`` and ``sample_mask``
    ``[F, B]``; trial t's accumulators see only its own rows."""
    probs = probs.to(torch.float32)
    labels = labels.to(torch.float32)
    m = sample_mask.to(torch.float32)
    f, _, n_classes = probs.shape
    correct = ((probs.argmax(-1) == labels.argmax(-1)) * m).sum(-1)

    th = auc_thresholds(state.auc_tp.shape[-1], probs.device)
    p_flat = probs.reshape(f, -1)
    y_flat = labels.reshape(f, -1)
    m_flat = m.repeat_interleave(n_classes, dim=1)
    pred_pos = (p_flat[:, None, :] > th[None, :, None]).to(torch.float32)
    w_pos = y_flat * m_flat
    w_neg = (1.0 - y_flat) * m_flat
    tp = torch.bmm(pred_pos, w_pos[:, :, None])[..., 0]
    fp = torch.bmm(pred_pos, w_neg[:, :, None])[..., 0]

    cls_pred = (probs > 1.0 / n_classes).to(torch.float32) * m[..., None]
    state.n += m.sum(-1)
    state.correct += correct
    state.loss_sum += (loss.to(torch.float32) * m).sum(-1)
    state.auc_tp += tp
    state.auc_fp += fp
    state.auc_fn += w_pos.sum(-1, keepdim=True) - tp
    state.auc_tn += w_neg.sum(-1, keepdim=True) - fp
    state.cls_tp += (cls_pred * labels).sum(1)
    state.cls_fp += (cls_pred * (1.0 - labels)).sum(1)
    state.cls_fn += ((1.0 - cls_pred) * labels * m[..., None]).sum(1)


def compute_stacked_metrics(state: MetricsState,
                            class_names: Optional[Sequence[str]] = None
                            ) -> List[Dict[str, float]]:
    """Each trial's :func:`compute_metrics` of a stacked state (one
    device-to-host copy)."""
    host = MetricsState(**{f.name: getattr(state, f.name).detach().to("cpu")
                           for f in dataclasses.fields(state)})
    return [compute_metrics(MetricsState(**{
        f.name: getattr(host, f.name)[t] for f in dataclasses.fields(host)}),
        class_names) for t in range(host.n.shape[0])]


def compute_metrics(state: MetricsState,
                    class_names: Optional[Sequence[str]] = None
                    ) -> Dict[str, float]:
    """Finalize to floats on the host (one device-to-host copy)."""
    s = {f.name: getattr(state, f.name).detach().to("cpu", torch.float32)
         for f in dataclasses.fields(state)}
    n = torch.clamp(s["n"], min=1.0)
    tpr = s["auc_tp"] / torch.clamp(s["auc_tp"] + s["auc_fn"], min=_EPS)
    fpr = s["auc_fp"] / torch.clamp(s["auc_fp"] + s["auc_tn"], min=_EPS)
    # Thresholds ascend, so fpr and tpr descend: a trapezoid over them.
    auc = ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()
    precision = s["cls_tp"] / torch.clamp(s["cls_tp"] + s["cls_fp"], min=_EPS)
    recall = s["cls_tp"] / torch.clamp(s["cls_tp"] + s["cls_fn"], min=_EPS)
    out = {"loss": float(s["loss_sum"] / n),
           "accuracy": float(s["correct"] / n), "auc": float(auc)}
    names = class_names or [str(i) for i in range(len(s["cls_tp"]))]
    for i, cname in enumerate(names):
        out[f"precision_{cname}"] = float(precision[i])
        out[f"recall_{cname}"] = float(recall[i])
    return out
