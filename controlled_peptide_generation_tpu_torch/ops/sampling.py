"""Free-running generation: a step loop of the decoder in every sampling
mode (``sample_sentences``), or the same loop over precomputed logits,
the deconv family's replay (``sample_from_logits``).

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

import contextlib

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


def gumbel(shape, gen=None, device="cpu", out=None):
    """Standard Gumbel noise -log(-log(U)), U ~ U(tiny, 1); with ``out``
    (float32, ``shape``) written into it, the same bits."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.empty(shape, device=device) if out is None else out
    u.uniform_(generator=gen).clamp_min_(tiny)
    return torch.log(u, out=u).neg_().log_().neg_()


def _check_mode(sample_mode, prevent_empty):
    if sample_mode not in HARD_MODES + SOFT_MODES:
        raise ValueError(f"unknown sample_mode {sample_mode!r}")
    if sample_mode in SOFT_MODES and prevent_empty:
        raise ValueError("cant prevent_empty when soft sampling")


def _grad_mode(sample_mode):
    """The soft modes run under the caller's autograd; hard modes without."""
    return (contextlib.nullcontext() if sample_mode in SOFT_MODES
            else torch.no_grad())


def sample_sentences(model, params, z, c, sample_mode="categorical",
                     temp=1.0, prepend_start_idx=True, prevent_empty=False,
                     gen=None, noise=None):
    """Generate from z [B, z_dim] and c [B, c_dim], T = model.max_seq_len
    steps. Hard modes: [B, T(+1)] token ids (int32). Soft modes: (tokens,
    soft rows [B, T(+1), V]). With prepend_start_idx column 0 is START
    (its soft row the START one-hot). ``noise`` [T, B, V] is the Gumbel
    noise of the categorical modes (drawn from ``gen`` when not given).
    The deconv family has no step (``models/rnn_vae.py`` raises): its
    logits replay through ``sample_from_logits``."""
    _check_mode(sample_mode, prevent_empty)
    h = [model.init_decoder_hidden(params, z, c)]

    def step_logits(t, tok, soft_row):
        # the transformer's cache holds the latent prefix at position 0
        logits, h[0] = model.decode_step(params, tok, soft_row, z, c, h[0],
                                         write_pos=t + 1)
        return logits

    with _grad_mode(sample_mode):
        return _sample(step_logits, z.shape[0], model.max_seq_len,
                       model.n_vocab, z.device, sample_mode, temp,
                       prepend_start_idx, prevent_empty, gen, noise)


def sample_from_logits(all_logits, sample_mode="categorical", temp=1.0,
                       prepend_start_idx=True, prevent_empty=False,
                       gen=None, noise=None):
    """The sampler over precomputed logits [B, T, V] (the deconv family's
    replay: step t reads row t whatever was sampled before it), with the
    modes, the EOS/PAD bookkeeping and the outputs of
    ``sample_sentences``; ``noise`` [T, B, V] as there."""
    _check_mode(sample_mode, prevent_empty)
    B, T, V = all_logits.shape
    with _grad_mode(sample_mode):
        return _sample(lambda t, tok, soft_row: all_logits[:, t], B, T, V,
                       all_logits.device, sample_mode, temp,
                       prepend_start_idx, prevent_empty, gen, noise)


def _sample(step_logits, B, T, V, dev, sample_mode, temp, prepend_start_idx,
            prevent_empty, gen, noise):
    """The step loop: ``step_logits(t, token, soft row)`` gives step t's
    logits [B, V] from the tokens (and soft rows) of step t - 1."""
    soft = sample_mode in SOFT_MODES
    categorical = sample_mode in ("categorical", "categorical_softmax")
    if categorical and noise is None:
        noise = gumbel((T, B, V), gen, dev)
    start = torch.full((B,), START_IDX, dtype=torch.long, device=dev)
    start_row = torch.nn.functional.one_hot(start, V).float()
    tok, soft_row = start, (start_row if soft else None)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    toks, softs = [], []
    for t in range(T):
        logits = step_logits(t, tok, soft_row).float()
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
