"""Bytes models, peaks and CUDA symbols of the hand kernels."""
