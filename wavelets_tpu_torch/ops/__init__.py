"""Torch engines, band tables, CUDA kernel wrappers and the 2-D driver."""
