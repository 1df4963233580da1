"""Latent density models, logistic heads and the fused CLaSS round."""
