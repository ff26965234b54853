"""MetricTracker: batch-averaged scalars, as the reference's pandas-based
tracker without pandas; each update may also go to a TensorBoard-style
writer. A copy of `stinet_tpu/metrics/tracker.py`."""
from collections import defaultdict


class MetricTracker:
    def __init__(self, *keys, writer=None):
        self.writer = writer
        self._keys = list(keys)
        self.reset()

    def reset(self):
        self._total = defaultdict(float)
        self._counts = defaultdict(int)

    def update(self, key, value, n=1, write=True):
        if self.writer is not None and write:
            self.writer.add_scalar(key, value)
        self._total[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key):
        c = self._counts[key]
        return self._total[key] / c if c else 0.0

    def result(self, write=False):
        out = {k: self.avg(k) for k in self._counts}
        if self.writer is not None and write:
            for k, v in out.items():
                self.writer.add_scalar(k, v)
        return out
