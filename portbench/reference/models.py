"""The sequence autoencoders of the configurations, plainly in float32:
the GRU family of the CLaSS paper (a biGRU encoder, a GRU decoder whose
input is [emb(token), z, c] at every step, started from h0 = [z, c]) and
the transformer family (pre-LN blocks with learned positions; the decoder
conditioned by proj([z, c]) at position 0, which every token attends to).

Parameters are nested dicts of tensors, ``x @ w + b`` with ``w`` [in,
out]; ``param_spec`` lists every leaf with its shape and its initial
distribution, so the benchmark can make one tree from a seed and hand it
to both the program and this reference.

The GRU cell is torch's convention: gates r, z, n along the 3H axis and
``n = tanh(gi_n + r * (h @ wh_n + bh_n))``. LayerNorm takes its eps 1e-6
inside the square root, GELU is the tanh form, attention logits are
divided by sqrt(head width) and masked at -1e30.
"""

import torch

from .common import PAD, UNK, embedding_table, linear

# ---------------------------------------------------------------------------
# the parameter tree
# ---------------------------------------------------------------------------


def _lin(prefix, n_in, n_out):
    bound = 1.0 / n_in ** 0.5
    return [(prefix + ("w",), (n_in, n_out), "uniform", bound),
            (prefix + ("b",), (n_out,), "uniform", bound)]


def _gru(prefix, n_in, h):
    bound = 1.0 / h ** 0.5
    return [(prefix + (k,), s, "uniform", bound)
            for k, s in (("wi", (n_in, 3 * h)), ("wh", (h, 3 * h)),
                         ("bi", (3 * h,)), ("bh", (3 * h,)))]


def _ln(prefix, d):
    return [(prefix + ("g",), (d,), "ones", None),
            (prefix + ("b",), (d,), "zeros", None)]


def _blocks(prefix, L, D, F):
    out = []
    for i in range(L):
        p = prefix + ("blocks", i)
        out += (_ln(p + ("ln1",), D) + _lin(p + ("qkv",), D, 3 * D)
                + _lin(p + ("attn_out",), D, D) + _ln(p + ("ln2",), D)
                + _lin(p + ("ff1",), D, F) + _lin(p + ("ff2",), F, D))
    return out


def param_spec(cfg):
    """[(path, shape, kind, bound)] of every leaf: kind "uniform" is
    U(-bound, bound), "normal" N(0, 1) times bound, "ones", "zeros"; the
    embedding is N(0, 1) with its PAD row zeroed ("embedding")."""
    V, E, Z, C, T = (cfg["n_vocab"], cfg["emb_dim"], cfg["z_dim"],
                     cfg["c_dim"], cfg["max_seq_len"])
    spec = [(("emb", "w"), (V, E), "embedding", 1.0)]
    if cfg["family"] == "gru":
        He, Hd = cfg["enc_h_dim"], Z + C
        spec += (_gru(("enc", "gru_fwd"), E, He) + _gru(("enc", "gru_bwd"), E, He)
                 + _lin(("enc", "mu"), 2 * He, Z)
                 + _lin(("enc", "logvar"), 2 * He, Z)
                 + _gru(("dec", "gru"), E + Hd, Hd)
                 + _lin(("dec", "out"), Hd, V))
        return spec
    D, L, F = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    spec += (_lin(("enc", "in"), E, D)
             + [(("enc", "pos"), (T + 1, D), "normal", 0.02)]
             + _blocks(("enc",), L, D, F) + _ln(("enc", "ln_f"), D)
             + _lin(("enc", "mu"), D, Z) + _lin(("enc", "logvar"), D, Z))
    spec += (_lin(("dec", "in"), E, D) + _lin(("dec", "latent"), Z + C, D)
             + [(("dec", "pos"), (T + 1, D), "normal", 0.02)]
             + _blocks(("dec",), L, D, F) + _ln(("dec", "ln_f"), D)
             + _lin(("dec", "out"), D, V))
    return spec


def set_leaf(tree, path, value):
    """Put ``value`` at ``path`` in nested dicts, a list where a path part
    is an integer (the transformer's blocks)."""
    node = tree
    for part, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= part:
                node.append(None)
            if node[part] is None:
                node[part] = [] if isinstance(nxt, int) else {}
            node = node[part]
        else:
            node = node.setdefault(part, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def leaves(tree, prefix=()):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, list):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves(v, prefix + (k,))
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def embed(emb, tokens):
    return embedding_table(emb)[tokens.long()]


def layer_norm(p, x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def attention(q, k, v, mask):
    """q [B, Sq, H, Dh], k and v [B, Sk, H, Dh], mask broadcastable to
    [B, H, Sq, Sk] (True: attend)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def block(p, x, mask, n_heads):
    """One pre-LN block over x [B, S, D]; the fused qkv's columns are
    head-major, [H, (q, k, v), Dh]."""
    B, S, D = x.shape
    qkv = linear(p["qkv"], layer_norm(p["ln1"], x)).reshape(
        B, S, n_heads, 3, D // n_heads)
    a = attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :], mask)
    x = x + linear(p["attn_out"], a.reshape(B, S, D))
    h = gelu(linear(p["ff1"], layer_norm(p["ln2"], x)))
    return x + linear(p["ff2"], h)


def gru_scan(p, xs, h0, reverse=False):
    """xs [B, T, in] from h0 [B, H] -> (hs [B, T, H], the last state); a
    reverse scan consumes xs[:, T-1] first."""
    order = range(xs.shape[1] - 1, -1, -1) if reverse else range(xs.shape[1])
    gi_all = xs @ p["wi"] + p["bi"]
    h, hs = h0, [None] * xs.shape[1]
    for t in order:
        i_r, i_z, i_n = gi_all[:, t].chunk(3, -1)
        h_r, h_z, h_n = (h @ p["wh"] + p["bh"]).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        zg = torch.sigmoid(i_z + h_z)
        h = (1.0 - zg) * torch.tanh(i_n + r * h_n) + zg * h
        hs[t] = h
    return torch.stack(hs, 1), h


# ---------------------------------------------------------------------------
# encoders and teacher-forced decoders
# ---------------------------------------------------------------------------


def encode(cfg, params, tokens):
    """tokens [B, T] -> (mu, logvar) [B, Z]."""
    x = embed(params["emb"], tokens)
    enc = params["enc"]
    if cfg["family"] == "gru":
        h0 = x.new_zeros((x.shape[0], cfg["enc_h_dim"]))
        _, hf = gru_scan(enc["gru_fwd"], x, h0)
        _, hb = gru_scan(enc["gru_bwd"], x, h0, reverse=True)
        h = torch.cat([hf, hb], 1)
        return linear(enc["mu"], h), linear(enc["logvar"], h)
    T = tokens.shape[1]
    real = tokens != PAD
    x = linear(enc["in"], x) + enc["pos"][:T]
    for p in enc["blocks"]:
        x = block(p, x, real[:, None, None, :], cfg["n_heads"])
    x = layer_norm(enc["ln_f"], x)
    pooled = (x * real[:, :, None]).sum(1) / real.sum(1, keepdim=True).clamp(
        min=1)
    return linear(enc["mu"], pooled), linear(enc["logvar"], pooled)


def decode_logits(cfg, params, inputs, z, c, out_keep=None, p_out_drop=0.0):
    """Logits [B, T, V] of the next token after each of ``inputs`` [B, T]
    (the decoder's inputs, word dropout already applied), given z and c.
    ``out_keep`` [B, T, H] is the GRU head's dropout mask."""
    dec = params["dec"]
    x = embed(params["emb"], inputs)
    zc = torch.cat([z, c], 1)
    if cfg["family"] == "gru":
        zc_t = zc[:, None, :].expand(-1, inputs.shape[1], -1)
        hs, _ = gru_scan(dec["gru"], torch.cat([x, zc_t], 2), zc)
        if out_keep is not None:
            hs = torch.where(out_keep, hs / (1.0 - p_out_drop),
                             torch.zeros_like(hs))
        return linear(dec["out"], hs)
    T = inputs.shape[1]
    x = torch.cat([linear(dec["latent"], zc)[:, None, :],
                   linear(dec["in"], x)], 1) + dec["pos"][:T + 1]
    causal = torch.tril(torch.ones((T + 1, T + 1), dtype=torch.bool,
                                   device=x.device))
    for p in dec["blocks"]:
        x = block(p, x, causal[None, None], cfg["n_heads"])
    return linear(dec["out"], layer_norm(dec["ln_f"], x))[:, 1:]


def word_dropout(tokens, drop):
    return torch.where(drop, torch.full_like(tokens, UNK), tokens)
