"""Plain references of what the benchmark's cells run: float32 PyTorch and
NumPy, with TF32 off. Nothing here imports JAX, the JAX package or the
port; where a plain version of the port's served as the model, the code
is a frozen copy, so later changes to the port do not move the yardstick.
"""
