"""Graph-domain quality metrics and the metric tracker of the port."""
from stinet_tpu_torch.metrics.tracker import MetricTracker  # noqa: F401
