"""Free-running generation, hard-token modes: a step loop of the decoder.

Each step: one decoder step, token selection ('categorical' with a
temperature, or 'greedy'), then the finished bookkeeping: rows that have
emitted EOS emit PAD from the next step on. The categorical draw is the
argmax of logits / temp plus Gumbel noise, as ``jax.random.categorical``
draws it; the noise [T, B, V] comes from a ``torch.Generator`` or is
passed in. The soft modes (phase-2 training) are not ported yet.
"""

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX

HARD_MODES = ("categorical", "greedy")


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


@torch.no_grad()
def sample_sentences(model, params, z, c, sample_mode="categorical",
                     temp=1.0, prepend_start_idx=True, prevent_empty=False,
                     gen=None, noise=None):
    """Generate [B, T(+1)] token ids (int32); z [B, z_dim], c [B, c_dim],
    T = model.max_seq_len. With prepend_start_idx column 0 is START.
    ``noise`` [T, B, V] is the Gumbel noise of 'categorical' (drawn from
    ``gen`` when not given)."""
    if sample_mode not in HARD_MODES:
        raise NotImplementedError(
            f"sample_mode {sample_mode!r}: the port has {HARD_MODES} (the "
            f"soft modes are queued in ROADMAP.md A7)")
    B, T, dev = z.shape[0], model.max_seq_len, z.device
    if sample_mode == "categorical" and noise is None:
        noise = gumbel((T, B, model.n_vocab), gen, dev)
    tok = torch.full((B,), START_IDX, dtype=torch.long, device=dev)
    h = model.init_decoder_hidden(params, z, c)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = []
    for t in range(T):
        logits, h = model.decode_step(params, tok, None, z, c, h)
        logits = logits.float()
        if prevent_empty and t == 0:
            logits = _mask_specials_first_step(logits)
        if sample_mode == "categorical":
            new_tok = torch.argmax(logits / temp + noise[t], dim=1)
        else:
            new_tok = torch.argmax(logits, dim=1)
        new_tok = torch.where(finished, PAD_IDX, new_tok)
        finished = finished | (new_tok == EOS_IDX)
        out.append(new_tok)
        tok = new_tok
    seq = torch.stack(out, dim=1)
    if prepend_start_idx:
        seq = torch.cat([torch.full((B, 1), START_IDX, dtype=torch.long,
                                    device=dev), seq], dim=1)
    return seq.int()
