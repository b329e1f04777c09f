"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

Kernels are compiled from ../csrc at first use (see _build.py); importing
this package compiles and loads nothing.
"""
