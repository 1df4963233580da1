"""GRU decoder: the teacher-forced pass of training and the free-running
step of sampling and the beam search.

The hidden state is concat(z, c) (h_dim = z_dim + c_dim) and the input at
every step is [emb(token), z, c]. Its GRU input projection factors into a
token part, a [V, 3H] table, and a (z, c) part, one [B, 3H] row per
sequence; both are loop-invariant inside a decode, so only the recurrent
[B, H] x [H, 3H] product remains per step.

In the teacher-forced pass, word dropout turns inputs into UNK before the
embedding, the whole sequence runs through ``gru_scan`` from h0 = zc, and
the head applies output dropout. The dropout masks come from a
``torch.Generator`` or are passed in.
"""

import torch

from ..data.vocab import UNK_IDX
from ..ops import nn
from ..ops.gru import init_gru_params, gru_cell_pregated, gru_scan


def init(gen, emb_dim, output_dim, h_dim, device="cpu"):
    """emb_dim is the FULL per-step input width (word emb + z + c)."""
    return {
        "gru": init_gru_params(gen, emb_dim, h_dim, device),
        "out": nn.init_linear(gen, h_dim, output_dim, device),
    }


def init_hidden(z, c):
    return torch.cat([z, c], dim=1)


def _head(params, rnn_out, p_out_dropout, train, gen=None, keep=None):
    rnn_out = nn.dropout(rnn_out, p_out_dropout, train, gen, keep)
    return nn.linear(params["out"], rnn_out)


def apply_teacher_forced(params, emb_params, tokens, z, c, train,
                         p_word_dropout=0.3, p_out_dropout=0.3, gen=None,
                         word_drop=None, out_keep=None):
    """tokens: [B, T] int -> logits [B, T, V]. ``word_drop`` [B, T] and
    ``out_keep`` [B, T, H] (bool) are the dropout masks; those not given
    are drawn from ``gen``."""
    x = nn.word_dropout(tokens, p_word_dropout, UNK_IDX, train, gen,
                        word_drop)
    emb = nn.embed(emb_params, x)                          # [B, T, E]
    zc = init_hidden(z, c)                                 # [B, H]
    zc_t = zc[:, None, :].expand(zc.shape[0], tokens.shape[1], zc.shape[1])
    inputs = torch.cat([emb, zc_t], dim=2)
    rnn_out, _ = gru_scan(params["gru"], inputs, zc)
    return _head(params, rnn_out, p_out_dropout, train, gen, out_keep)


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
