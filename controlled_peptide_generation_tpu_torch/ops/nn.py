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

The transformer family's helpers keep the JAX package's numerics, not
torch's defaults: ``layer_norm`` takes its eps (1e-6) inside the rsqrt,
where ``torch.nn.functional.layer_norm`` defaults to 1e-5, and ``gelu`` is
the tanh approximation (``jax.nn.gelu``'s default), not torch's erf form;
either default moves logits by about 1e-3.
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
    """x @ w + b (``matmul``'s product)."""
    return matmul(x, p["w"]) + p["b"]


def matmul(x, w):
    """x @ w. Mixed float types compute in the wider one, as jnp's
    promotion does (torch's matmul refuses mixed types). A bf16 product is
    accumulated in f32 and rounded once, as XLA computes it (cuBLAS may
    otherwise reduce partial sums in bf16)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


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


def soft_embed(p, soft_ix):
    """[..., V] probabilities -> [..., emb_dim] (the PAD row zeroed)."""
    return soft_ix @ embedding_table(p).to(soft_ix.dtype)


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


def init_layer_norm(d, device="cpu"):
    return {"g": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def layer_norm(p, x, eps=1e-6):
    """LayerNorm over the last axis in f32, cast back to x's type:
    population variance, ``(x - mean) * rsqrt(var + eps) * g + b``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def gelu(x):
    """The tanh approximation of GELU in f32, cast back to x's type."""
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


def init_conv1d_seq(gen, width, in_dim, n_filters, device="cpu"):
    """A Kim-2014 text-conv filter bank over the embeddings, in the JAX
    package's layout: w [width, in_dim, n_filters] ("WIO"), b
    [n_filters], both ~ U(-1/sqrt(width * in_dim), ...)."""
    bound = 1.0 / (width * in_dim) ** 0.5
    return {"w": uniform(gen, (width, in_dim, n_filters), bound, device),
            "b": uniform(gen, (n_filters,), bound, device)}


def conv1d_seq(p, x):
    """x [B, T, E] -> [B, T - width + 1, F]: the valid convolution along T
    (a cross-correlation, as XLA's conv)."""
    w = p["w"].permute(2, 1, 0)                      # [F, E, width]
    y = torch.nn.functional.conv1d(x.transpose(1, 2), w)
    return y.transpose(1, 2) + p["b"]


def cast_tree(tree, dtype):
    """Cast the float32 leaves of nested dicts and lists to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree
