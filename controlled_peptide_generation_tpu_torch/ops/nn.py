"""Parameter init and tiny functional layers.

Parameters live in nested dicts of tensors with the JAX package's names
and layouts (``x @ w + b``: ``w`` is ``[in, out]``). Initializers follow
the torch defaults the JAX package reproduces:

* linear: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
* embedding: N(0, 1) with the PAD row zeroed;
* GRU: all weights and biases ~ U(-1/sqrt(h_dim), 1/sqrt(h_dim)).

The random layers (``dropout``, ``word_dropout``) draw their masks from a
``torch.Generator`` or take them as arguments, so tests can feed the JAX
package's draws.
"""

import torch

from ..data.vocab import PAD_IDX


def uniform(gen, shape, bound, device="cpu"):
    u = torch.rand(shape, generator=gen, device=device)
    return (2.0 * u - 1.0) * bound


def init_linear(gen, in_dim, out_dim, device="cpu"):
    bound = 1.0 / in_dim ** 0.5
    return {"w": uniform(gen, (in_dim, out_dim), bound, device),
            "b": uniform(gen, (out_dim,), bound, device)}


def linear(p, x):
    return x @ p["w"] + p["b"]


def init_embedding(gen, n_vocab, emb_dim, device="cpu"):
    w = torch.randn((n_vocab, emb_dim), generator=gen, device=device)
    w[PAD_IDX] = 0.0
    return {"w": w}


def embedding_table(p):
    """The embedding matrix with the PAD row zeroed (PAD always embeds to
    the zero vector)."""
    w = p["w"].clone()
    w[PAD_IDX] = 0.0
    return w


def embed(p, ix):
    """Hard token lookup with the PAD row zeroed."""
    return table_lookup(embedding_table(p), ix)


def onehot(ix, n, dtype=torch.float32):
    return torch.nn.functional.one_hot(ix.long(), n).to(dtype)


def canonical_zeros(x):
    """-0.0 -> +0.0; arithmetically inert, keeps emitted bits equal to the
    JAX package's (its one-hot lookup turns -0.0 into +0.0)."""
    return torch.where(x == 0.0, torch.zeros_like(x), x)


def table_lookup(table, ix):
    """table[ix] for a tiny [V, D] table: a plain gather."""
    return canonical_zeros(table)[ix.long()]


def dropout(x, rate, train, gen=None, keep=None):
    """Inverted dropout: x / (1 - rate) where kept, 0 elsewhere. ``keep``
    (bool, x's shape) is the mask; without it one is drawn from ``gen``."""
    if not train or rate <= 0.0:
        return x
    p_keep = 1.0 - rate
    if keep is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p_keep
    return torch.where(keep, x / p_keep, torch.zeros_like(x))


def word_dropout(tokens, rate, unk_idx, train, gen=None, drop=None):
    """Replace tokens with UNK with probability ``rate`` (decoder input
    corruption). ``drop`` (bool, tokens' shape) is the mask; without it
    one is drawn from ``gen``."""
    if not train or rate <= 0.0:
        return tokens
    if drop is None:
        drop = torch.rand(tokens.shape, generator=gen,
                          device=tokens.device) < rate
    return torch.where(drop, torch.full_like(tokens, unk_idx), tokens)
