"""Confusion matrix and IoU metrics for semantic segmentation, the
counterpart of `stinet_tpu/metrics/iou.py` (the reference's
confusionmatrix.py, iou.py and metrics_dcm.py): an accumulated confusion
matrix, per-class IoU with ignore_index, mean IoU, precision and overall
accuracy.

The running matrix stays on the device of the matrices added to it, so a
train step adds its matrix without a host copy, and it is exact: int64
counts (float64 where float matrices are added). A ScanNet epoch passes
more than 2^24 vertices of one class, past the integers f32 holds exactly.
`value()` copies it to the host once, as float64, and the final reductions
run there in numpy, as in the JAX package.
"""
import numpy as np
import torch


def confusion_matrix_update(predicted, target, num_classes, valid_mask=None):
    """[N] int predictions and targets -> [C, C] int64 counts on their
    device (rows = target, columns = predicted). Rows where `valid_mask`
    is 0 and pairs outside the matrix are not counted."""
    c = num_classes
    idx = target.to(torch.int64) * c + predicted.to(torch.int64)
    keep = (idx >= 0) & (idx < c * c)
    if valid_mask is not None:
        keep = keep & (valid_mask != 0)
    # dropped rows go to one extra bin, so nothing waits on the host
    idx = torch.where(keep, idx, torch.full_like(idx, c * c))
    counts = torch.zeros(c * c + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:c * c].reshape(c, c)


def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


class ConfusionMatrix:
    def __init__(self, num_classes, normalized=False):
        self.num_classes = num_classes
        self.normalized = normalized
        self.reset()

    def reset(self):
        self._conf = None

    def add(self, predicted, target, valid_mask=None):
        self.add_matrix(confusion_matrix_update(
            _tensor(predicted), _tensor(target), self.num_classes,
            None if valid_mask is None else _tensor(valid_mask)))

    def add_matrix(self, conf):
        conf = _tensor(conf)
        if conf.is_floating_point():
            conf = conf.to(torch.float64)
        self._conf = (conf.clone() if self._conf is None
                      else self._conf + conf.to(self._conf.device))

    @property
    def conf(self):
        """The running matrix on the host, float64."""
        if self._conf is None:
            return np.zeros((self.num_classes,) * 2, np.float64)
        return self._conf.cpu().numpy().astype(np.float64)

    def value(self):
        conf = self.conf
        if self.normalized:
            rows = conf.sum(axis=1, keepdims=True)
            return conf / np.maximum(rows, 1e-12)
        return conf


class IoU:
    """IoU = TP / (TP + FP + FN) per class of the accumulated confusion
    matrix. `value()` returns (per-class IoU, mean IoU): the ignored
    classes are NaN, and NaN classes (no target and no prediction) are
    left out of the mean (reference iou.py:60-100)."""

    def __init__(self, num_classes, normalized=False, ignore_index=None):
        self.conf_metric = ConfusionMatrix(num_classes, normalized)
        if ignore_index is None:
            self.ignore_index = ()
        elif isinstance(ignore_index, int):
            self.ignore_index = (ignore_index,)
        else:
            self.ignore_index = tuple(ignore_index)

    def reset(self):
        self.conf_metric.reset()

    def add(self, predicted, target, valid_mask=None):
        self.conf_metric.add(predicted, target, valid_mask)

    def add_matrix(self, conf):
        self.conf_metric.add_matrix(conf)

    def _kept(self):
        conf = self.conf_metric.value().copy()
        for i in self.ignore_index:
            conf[:, i] = 0
            conf[i, :] = 0
        return conf

    def _ignored_nan(self, per_class):
        for i in self.ignore_index:
            per_class[i] = np.nan
        return per_class, np.nanmean(per_class)

    def value(self):
        conf = self._kept()
        tp = np.diag(conf)
        fp = conf.sum(0) - tp
        fn = conf.sum(1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = tp / (tp + fp + fn)
        return self._ignored_nan(iou)

    def precision(self):
        conf = self._kept()
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.diag(conf) / conf.sum(0)
        return self._ignored_nan(prec)

    def overall_accuracy(self):
        conf = self._kept()
        return float(np.diag(conf).sum() / max(conf.sum(), 1e-12))
