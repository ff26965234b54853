"""Data loading of the port: the ScanNet colour loader, its transforms and
the prefetch thread."""
