"""``paddle.metric`` for the port (the counterpart of
``paddle_tpu/metric/__init__.py``): ``Metric``, ``Accuracy``,
``Precision``, ``Recall``, ``Auc``.

As in JAX, a metric's ``update`` and ``accumulate`` run on the host in
numpy, outside the training step. ``Accuracy.compute`` runs where the
predictions are (``torch.topk`` on the card), so only the ``[..., maxk]``
hit matrix crosses to the host, in ``update``. bf16 predictions reach the
host widened to float32.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base metric: ``reset`` / ``update`` / ``accumulate`` / ``name``;
    ``compute`` optionally turns ``(pred, label)`` into ``update``'s
    inputs where the predictions are."""

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """``[..., maxk]`` bool: whether the i-th highest score is the
        label, on the predictions' device."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        if label.dim() == pred.dim() and label.shape[-1] == 1:
            label = label[..., 0]
        order = torch.topk(pred, self.maxk, dim=-1).indices
        return order == label[..., None]

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        num = int(np.prod(c.shape[:-1]))
        for i, k in enumerate(self.topk):
            n = float(c[..., :k].sum())
            accs.append(n / max(num, 1))
            self.total[i] += n
            self.count[i] += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of scores in [0, 1] thresholded at 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_host(preds).reshape(-1) > 0.5).astype(np.int64)
        lab = _host(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of scores in [0, 1] thresholded at 0.5."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_host(preds).reshape(-1) > 0.5).astype(np.int64)
        lab = _host(labels).reshape(-1).astype(np.int64)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` score buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _host(labels).reshape(-1).astype(np.int64)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        # trapezoids from the highest bucket down, in one pass
        pos = np.cumsum(self._stat_pos[::-1]).astype(np.float64)
        neg = np.cumsum(self._stat_neg[::-1]).astype(np.float64)
        prev_pos = np.concatenate([[0.0], pos[:-1]])
        prev_neg = np.concatenate([[0.0], neg[:-1]])
        auc = float(np.sum((pos + prev_pos) * (neg - prev_neg) / 2.0))
        d = pos[-1] * neg[-1]
        return float(auc / d) if d else 0.0

    def name(self):
        return self._name
