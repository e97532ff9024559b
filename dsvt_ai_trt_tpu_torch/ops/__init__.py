"""Tensor operations of the detector and the wrappers of the CUDA kernels."""
