"""Metrics (counterpart of paddle_tpu/metric; reference
python/paddle/metric/metrics.py).

They compute on the host in numpy, as the reference's do. `Accuracy`
ranks with `np.argsort(-pred)`, numpy's default (unstable) sort, and not
with `torch.topk`: among tied scores the two order differently, and the
port keeps the reference's order (ROADMAP C).
"""
import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        if label.ndim == pred.ndim and label.shape[-1] > 1:
            label = label.argmax(-1)  # one-hot → index
        label = label.reshape(label.shape[0], -1)
        topk_idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        correct = topk_idx == label[..., :1]
        return torch.from_numpy(correct.astype("float32"))

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0]
        for i, k in enumerate(self.topk):
            c = correct[..., :k].sum()
            self.total[i] += float(c)
            self.count[i] += num
        return self.total[0] / max(self.count[0], 1)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int32").reshape(-1)
        labels = _np(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int32").reshape(-1)
        labels = _np(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Thresholded-bucket AUC (reference: metrics.py Auc — the bucketed
    trapezoid estimator of the C++ fleet metric)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = (pos_prob * self.num_thresholds).astype("int64")
        bins = np.clip(bins, 0, self.num_thresholds)
        pos = labels != 0
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (paddle.metric.accuracy): a float32
    scalar CPU tensor."""
    pred = _np(input)
    lab = _np(label).reshape(-1, 1)
    topk_idx = np.argsort(-pred, axis=-1)[:, :k]
    acc = (topk_idx == lab).any(-1).mean()
    return torch.from_numpy(np.asarray(acc, dtype="float32"))
