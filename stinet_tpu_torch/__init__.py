"""stinet_tpu_torch: the PyTorch/CUDA port of stinet_tpu for NVIDIA Hopper.

Mirrors the layout of `stinet_tpu/`. Plain tensor code is PyTorch; each
TPU kernel of the JAX package is a hand-written CUDA kernel here
(`ops/cuda/`), built with nvcc on first use. The package imports neither
JAX nor `stinet_tpu`.
"""
