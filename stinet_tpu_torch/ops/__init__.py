"""Device ops of the port: the plain torch versions and the dispatch to
the hand-written CUDA kernels in `ops/cuda/`."""
