"""Data loading of the port: the ScanNet colour loader, its transforms and
the prefetch thread, and the 2D image-graph loader (registered here)."""
from stinet_tpu_torch.data import imagegraph  # noqa: F401
