"""Wrappers of the hand-written CUDA kernels."""
