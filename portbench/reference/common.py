"""Pieces every reference shares: numerics, the special tokens, and the
recipe that turns integer words (seed, round or step) into a generator."""

import numpy as np
import torch

UNK, PAD, START, EOS = 0, 1, 2, 3
NEG = -1e20


def full_fp32():
    """Full float32 products: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def generator(device, *words):
    """A torch.Generator on ``device`` seeded from a tuple of non-negative
    integers (a NumPy SeedSequence of the words, its first 64-bit state)."""
    mixed = np.random.SeedSequence([int(w) for w in words])
    gen = torch.Generator(device=device)
    return gen.manual_seed(int(mixed.generate_state(1, np.uint64)[0]))


def linear(p, x):
    return x @ p["w"] + p["b"]


def onehot(bits, n):
    return torch.nn.functional.one_hot(bits.long(), n).to(torch.float32)


def embedding_table(emb):
    """The embedding matrix with the PAD row zeroed."""
    w = emb["w"].clone()
    w[PAD] = 0.0
    return w
