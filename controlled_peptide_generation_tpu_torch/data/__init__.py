"""Vocabulary (copied from the JAX package; no jax inside)."""
