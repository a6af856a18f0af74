"""Per-task GLUE metrics (the port's own copy of
`sea_tpu/training/glue_metrics.py`; the definitions of sklearn, scipy and
HF `glue`):

  cola              -> Matthews correlation
  mrpc, qqp         -> accuracy and F1 (primary: F1)
  stsb              -> Pearson and Spearman r (primary: Pearson)
  everything else   -> accuracy
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def accuracy(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float((preds == labels).mean()) if len(labels) else 0.0


def _confusion(preds, labels):
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    return tp, tn, fp, fn


def f1_binary(preds, labels) -> float:
    """F1 of the positive class (HF glue's for mrpc and qqp)."""
    tp, _, fp, fn = _confusion(preds, labels)
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def matthews_corrcoef(preds, labels) -> float:
    tp, tn, fp, fn = _confusion(preds, labels)
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def pearson_r(x, y) -> float:
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    xm, ym = x - x.mean(), y - y.mean()
    denom = np.sqrt((xm ** 2).sum() * (ym ** 2).sum())
    return float((xm * ym).sum() / denom) if denom > 0 else 0.0


def _rank(x) -> np.ndarray:
    """Average ranks (ties share their mean rank), as scipy.stats.rankdata."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = ranks[order[i: j + 1]].mean()
        i = j + 1
    return ranks


def spearman_r(x, y) -> float:
    return pearson_r(_rank(x), _rank(y))


def glue_compute(subset: str, preds, labels) -> Dict[str, float]:
    """The task's metric dict (HF `glue`'s keys). `preds` are class ids, or
    raw scores for stsb."""
    if subset == "cola":
        return {"matthews_correlation": matthews_corrcoef(preds, labels)}
    if subset in ("mrpc", "qqp"):
        return {"accuracy": accuracy(preds, labels), "f1": f1_binary(preds, labels)}
    if subset == "stsb":
        return {"pearson": pearson_r(preds, labels), "spearmanr": spearman_r(preds, labels)}
    return {"accuracy": accuracy(preds, labels)}


def primary_score(subset: str, metrics: Dict[str, float]) -> float:
    """The one score the reference logs ('eval/score')."""
    for k in ("matthews_correlation", "f1", "pearson", "accuracy"):
        if k in metrics:
            return metrics[k]
    return next(iter(metrics.values()))
