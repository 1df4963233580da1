"""Batched beam search over the GRU decoder.

All (batch, beam) lanes advance together (ops/beam_kernel.py runs the
steps, as one CUDA kernel or as plain torch); finished hypotheses are then
rebuilt from the per-step tapes and walked back to token rows here.

Semantics, as in the JAX package's ops/beam.py:

* log-softmax scores accumulate additively in fp32; START is always
  blocked and EOS blocked below min_length, at -1e20;
* rows whose last token is EOS get their children blocked at -1e20;
* the first advance draws only from beam 0's distribution;
* a hypothesis is finished when its token is EOS, recorded in step-major,
  beam-minor order;
* a sentence is done when EOS tops the beam and >= n_best finished; done
  sentences emit PAD and stop advancing;
* finalization pads with current beams until n_best, stable-sorts by
  score descending and walks backpointers, including the BOS row.
"""

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX
from ..models import decoder
from . import beam_kernel


def _backtrace(t, k, ys, ptrs, T):
    """Walk backpointers from (t, k) [B, N]; ys [B, T+1, K], ptrs
    [B, T, K] -> [B, N, T+1] tokens, PAD beyond t."""
    toks = [None] * T
    k_cur = k
    for j in range(T - 1, -1, -1):
        on = (j + 1) <= t
        tok = torch.gather(ys[:, j + 1, :], 1, k_cur)
        toks[j] = torch.where(on, tok, PAD_IDX)
        k_cur = torch.where(on, torch.gather(ptrs[:, j, :], 1, k_cur), k_cur)
    first = torch.gather(ys[:, 0, :], 1, k_cur)
    return torch.stack([first] + toks, dim=2)


def _finalize(ys, ptrs, scores, adv, fin_cnt, fin_mask, fin_score, *, K,
              n_best, T):
    """sort_finished(minimum=n_best) + n_best backtraces for a batch.

    fin_mask/fin_score [B, T*K] are the per-step finish emissions
    flattened step-major (the heap's insertion order); the
    pad-with-current-beams entries follow all finish slots."""
    B = ys.shape[0]
    dev = ys.device
    i = torch.arange(n_best, device=dev)
    n_add = torch.clamp(n_best - fin_cnt.long(), min=0)
    flat = torch.arange(T * K, device=dev)
    pad_sc = scores[:, torch.clamp(i, max=K - 1)]
    keyed = torch.cat([
        torch.where(fin_mask, fin_score, float("-inf")),
        torch.where(i[None, :] < n_add[:, None], pad_sc, float("-inf")),
    ], dim=1)
    t_all = torch.cat([(flat // K + 1).expand(B, -1),
                       adv.long()[:, None].expand(B, n_best)], dim=1)
    k_all = torch.cat([(flat % K).expand(B, -1),
                       i.expand(B, n_best)], dim=1)
    order = torch.argsort(-keyed, dim=1, stable=True)[:, :n_best]
    ts = torch.gather(t_all, 1, order)
    ks = torch.gather(k_all, 1, order)
    sc = torch.gather(keyed, 1, order)
    return _backtrace(ts, ks, ys, ptrs, T), sc


def beam_search(model, params, z, c, beam_size=5, n_best=3, min_length=1,
                max_len=None, plain=False):
    """z [B, z_dim], c [B, c_dim] -> (hyps [B, n_best, T+1] int64,
    scores [B, n_best] f32). hyps[:, :, 0] is the BOS row token.

    The steps run in beam_kernel.beam_scan_gru: the CUDA kernel on CUDA
    tensors (raising where its scope does not cover the model), its plain
    version on CPU tensors. plain=True runs the plain version on any
    device; it exists only to hold the kernel against it."""
    if beam_size < n_best:
        raise ValueError("can't return more hypotheses than the beam holds")
    B, K = z.shape[0], beam_size
    V = model.n_vocab
    T = max_len if max_len is not None else model.max_seq_len
    if T > model.max_seq_len:
        raise ValueError(f"max_len {T} exceeds model.max_seq_len "
                         f"{model.max_seq_len}")
    if plain:
        scan = beam_kernel.beam_scan_gru_reference
    else:
        scan = beam_kernel.beam_scan_gru
        if z.device.type == "cuda" and not beam_kernel.applicable(
                model, K, z.dtype):
            raise ValueError("the CUDA beam kernel's scope does not cover "
                             "this model/beam/dtype (ops/beam_kernel.py "
                             "applicable)")

    dec = params["dec"]
    tok_table, zc_gi = decoder.step_tables(dec, params["emb"], z, c)
    zc0 = model.init_decoder_hidden(params, z, c)
    tapes = scan(tok_table, zc_gi, dec["gru"]["wh"], dec["gru"]["bh"],
                 dec["out"]["w"], dec["out"]["b"], zc0, T=T, K=K, V=V,
                 H=model.h_dec, min_length=min_length, n_best=n_best)
    return hyps_from_tapes(tapes, n_best)


def hyps_from_tapes(tapes, n_best):
    """The scan's (ys, ptr, sc [B, T, K], scores [B, K], adv [B], fin [B])
    -> (hyps [B, n_best, T+1], scores [B, n_best])."""
    ys_steps, ptr_steps, sc_steps, scores_f, adv_f, fin_f = tapes
    B, T, K = ys_steps.shape
    # done sentences emit PAD, never EOS, so this is the finish mask
    fin_mask = (ys_steps == EOS_IDX).reshape(B, T * K)
    prev0 = torch.full((B, 1, K), PAD_IDX, dtype=torch.long,
                       device=ys_steps.device)
    prev0[:, :, 0] = START_IDX
    ys = torch.cat([prev0, ys_steps.long()], dim=1)        # [B, T+1, K]
    return _finalize(ys, ptr_steps.long(), scores_f, adv_f, fin_f,
                     fin_mask, sc_steps.reshape(B, T * K), K=K,
                     n_best=n_best, T=T)
