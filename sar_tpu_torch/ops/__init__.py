"""Ops of the port: the mel frontend (plain torch) and the hand-written CUDA
kernels with their plain PyTorch versions.

Kernel modules import nothing CUDA-specific at import time: the shared
library is built and loaded by `_build.load()` at the first launch.
"""
