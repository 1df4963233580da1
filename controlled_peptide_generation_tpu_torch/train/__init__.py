"""Checkpoint IO in the JAX package's npz key format."""
