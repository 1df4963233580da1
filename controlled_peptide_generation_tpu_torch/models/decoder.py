"""GRU decoder: the free-running step used by the beam search.

The hidden state is concat(z, c) (h_dim = z_dim + c_dim) and the input at
every step is [emb(token), z, c]. Its GRU input projection factors into a
token part, a [V, 3H] table, and a (z, c) part, one [B, 3H] row per
sequence; both are loop-invariant inside a decode, so only the recurrent
[B, H] x [H, 3H] product remains per step.
"""

import torch

from ..ops import nn
from ..ops.gru import init_gru_params, gru_cell_pregated


def init(gen, emb_dim, output_dim, h_dim, device="cpu"):
    """emb_dim is the FULL per-step input width (word emb + z + c)."""
    return {
        "gru": init_gru_params(gen, emb_dim, h_dim, device),
        "out": nn.init_linear(gen, h_dim, output_dim, device),
    }


def init_hidden(z, c):
    return torch.cat([z, c], dim=1)


def step_tables(params, emb_params, z, c):
    """The loop-invariant pieces of apply_step: (tok_table [V, 3H] with
    signed zeros canonicalized, zc_gi [B, 3H] with bi folded in)."""
    wi, bi = params["gru"]["wi"], params["gru"]["bi"]
    emb_w = nn.embedding_table(emb_params).to(wi.dtype)
    E = emb_w.shape[1]
    tok_table = nn.canonical_zeros(emb_w @ wi[:E])
    zc = init_hidden(z, c)
    zc_gi = zc @ wi[E:] + bi
    return tok_table, zc_gi


def apply_step(params, emb_params, token_hard, token_soft, z, c, h):
    """One free-running step; token_soft ([B, V] probabilities) takes
    precedence over token_hard ([B] indices). Returns (logits [B, V],
    h' [B, H])."""
    tok_table, zc_gi = step_tables(params, emb_params, z, c)
    if token_soft is not None:
        gi = token_soft @ tok_table + zc_gi
    else:
        gi = nn.table_lookup(tok_table, token_hard) + zc_gi
    h_new = gru_cell_pregated(params["gru"], gi, h)
    return nn.linear(params["out"], h_new), h_new
