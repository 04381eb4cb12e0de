"""Hand-written Hopper kernels and their plain PyTorch versions.

Importing this package builds nothing: the CUDA sources in `csrc/` are
compiled at the first launch on a CUDA tensor (see `_build.py`).
"""
