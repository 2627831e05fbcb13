"""``paddle.metric`` (counterpart of ``paddle_tpu/metric/__init__.py``):
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

The metrics run on the host in numpy, as the reference's do: a tensor
argument (on any device) is copied to the host first, so a metric over
CUDA outputs synchronises with the card. ``Accuracy`` ranks by
``np.argsort(-pred)``, so ties break as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing of (pred, label) before update."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        flat = correct.reshape(-1, correct.shape[-1])
        n = flat.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += flat[:, :k].any(axis=-1).sum()
            self.count[i] += n
        res = self.total / np.maximum(self.count, 1)
        return res[0] if len(self.topk) == 1 else res

    def accumulate(self):
        res = (self.total / np.maximum(self.count, 1)).tolist()
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lbl = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lbl == 1)).sum())
        self.fp += int(((p == 1) & (lbl == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lbl = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lbl == 1)).sum())
        self.fn += int(((p == 0) & (lbl == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lbl = _np(labels).reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        for b, y in zip(bins, lbl):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over the thresholds, descending
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        return float(np.trapezoid(pos / tot_pos, neg / tot_neg))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The top-``k`` accuracy of one batch, a float32 CPU tensor."""
    pred = _np(input)
    lbl = _np(label).reshape(-1)
    topk_idx = np.argsort(-pred, axis=-1)[:, :k]
    corr = (topk_idx == lbl[:, None]).any(-1).mean()
    return torch.tensor(corr, dtype=torch.float32)
