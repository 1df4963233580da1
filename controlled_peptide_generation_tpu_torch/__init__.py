"""PyTorch/CUDA port of controlled_peptide_generation_tpu.

Module names mirror the JAX package so each counterpart is easy to find.
The package imports torch, numpy and the standard library only; it never
imports jax or the JAX package. Entry points run on CUDA unless the caller
passes ``--device cpu``.
"""
