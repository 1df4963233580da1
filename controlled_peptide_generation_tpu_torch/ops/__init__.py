"""Tensor ops, the beam search and its CUDA kernel wrapper."""
