"""Free-running generation: a step loop of the decoder in every sampling
mode.

Each step: one decoder step, token selection, then the finished
bookkeeping: rows that have emitted EOS emit PAD from the next step on.

* hard modes, 'categorical' (with a temperature) and 'greedy': tokens
  only, without autograd;
* soft modes (phase-2 training), 'none_softmax', 'greedy_softmax' and
  'categorical_softmax': the decoder is fed softmax(logits / temp) by
  soft embedding, and the soft rows come out beside the tokens, under
  autograd, so a loss on them reaches the decoder. The hard track only
  keeps the EOS bookkeeping: 'none_softmax' never updates it (its rows
  are never finished), the others take the greedy or the categorical
  token; the soft rows of finished sentences are zeroed.

The categorical draw is the argmax of logits / temp plus Gumbel noise, as
``jax.random.categorical`` draws it; the noise [T, B, V] comes from a
``torch.Generator`` or is passed in. The sampling math is in f32 whatever
type the decoder runs in. The step loop passes the transformer's cache
position as an int (no device sync a step).
"""

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX

HARD_MODES = ("categorical", "greedy")
SOFT_MODES = ("none_softmax", "greedy_softmax", "categorical_softmax")


def _mask_specials_first_step(logits):
    """prevent_empty: PAD/START/EOS get a large negative logit."""
    large_neg = -2.0 * logits.min().abs()
    out = logits.clone()
    out[:, [PAD_IDX, START_IDX, EOS_IDX]] = large_neg
    return out


def gumbel(shape, gen=None, device="cpu"):
    """Standard Gumbel noise -log(-log(U)), U ~ U(tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def sample_sentences(model, params, z, c, sample_mode="categorical",
                     temp=1.0, prepend_start_idx=True, prevent_empty=False,
                     gen=None, noise=None):
    """Generate from z [B, z_dim] and c [B, c_dim], T = model.max_seq_len
    steps. Hard modes: [B, T(+1)] token ids (int32). Soft modes: (tokens,
    soft rows [B, T(+1), V]). With prepend_start_idx column 0 is START
    (its soft row the START one-hot). ``noise`` [T, B, V] is the Gumbel
    noise of the categorical modes (drawn from ``gen`` when not given)."""
    if sample_mode not in HARD_MODES + SOFT_MODES:
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    if sample_mode in SOFT_MODES:
        if prevent_empty:
            raise ValueError("cant prevent_empty when soft sampling")
        return _sample(model, params, z, c, sample_mode, temp,
                       prepend_start_idx, False, gen, noise)
    with torch.no_grad():
        return _sample(model, params, z, c, sample_mode, temp,
                       prepend_start_idx, prevent_empty, gen, noise)


def _sample(model, params, z, c, sample_mode, temp, prepend_start_idx,
            prevent_empty, gen, noise):
    B, T, V, dev = z.shape[0], model.max_seq_len, model.n_vocab, z.device
    soft = sample_mode in SOFT_MODES
    categorical = sample_mode in ("categorical", "categorical_softmax")
    if categorical and noise is None:
        noise = gumbel((T, B, V), gen, dev)
    start = torch.full((B,), START_IDX, dtype=torch.long, device=dev)
    start_row = torch.nn.functional.one_hot(start, V).float()
    tok, soft_row = start, (start_row if soft else None)
    h = model.init_decoder_hidden(params, z, c)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    toks, softs = [], []
    for t in range(T):
        # the transformer's cache holds the latent prefix at position 0
        logits, h = model.decode_step(params, tok, soft_row, z, c, h,
                                      write_pos=t + 1)
        logits = logits.float()
        if prevent_empty and t == 0:
            logits = _mask_specials_first_step(logits)
        new_tok = tok
        if categorical:
            new_tok = torch.argmax(logits / temp + noise[t], dim=1)
        elif sample_mode in ("greedy", "greedy_softmax"):
            new_tok = torch.argmax(logits, dim=1)
        new_tok = torch.where(finished, PAD_IDX, new_tok)
        finished = finished | (new_tok == EOS_IDX)
        if soft:
            soft_row = torch.where(finished[:, None], 0.0,
                                   torch.softmax(logits / temp, dim=1))
            softs.append(soft_row)
        toks.append(new_tok)
        tok = new_tok
    seq = torch.stack(toks, dim=1)
    if prepend_start_idx:
        seq = torch.cat([start[:, None], seq], dim=1)
    seq = seq.int()
    if not soft:
        return seq
    soft_seq = torch.stack(softs, dim=1)
    if prepend_start_idx:
        soft_seq = torch.cat([start_row[:, None], soft_seq], dim=1)
    return seq, soft_seq
