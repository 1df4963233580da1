"""Beam search over the decoders, plainly: every step recomputes each
lane's whole prefix with the teacher-forced pass of ``models`` (no cache),
and keeps the CLaSS reference's bookkeeping (OpenNMT's ``Beam``):

* log-softmax scores add up in float32; START is never chosen;
* the first step expands beam 0 alone;
* a beam whose last token is EOS has its children blocked at -1e20, and a
  hypothesis is finished when its token is EOS;
* a sentence is done once EOS tops its beam with ``n_best`` finished;
  done sentences stop advancing;
* the best of the finished hypotheses (step-major, beam-minor order among
  equal scores), padded with the current beams where too few finished, is
  walked back to its tokens.

The top-K choice takes ties by the lowest flat index, and -0.0 counts as
+0.0, as the program's kernels do, so an exact tie resolves alike.
"""

import torch

from .common import EOS, NEG, PAD, START
from .models import decode_logits


def _topk_lowest(x, k):
    """The k largest of each row, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def beam_search(cfg, params, z, c, K=5, T=None, min_length=1):
    """Top-1 hypotheses of z, c [B, *]: (tokens [B, T+1] with START first
    and PAD after the end, scores [B])."""
    T = cfg["max_seq_len"] if T is None else T
    B, V, dev = z.shape[0], cfg["n_vocab"], z.device
    zl = z.repeat_interleave(K, 0)
    cl = c.repeat_interleave(K, 0)
    hist = torch.full((B, K, 1), PAD, dtype=torch.long, device=dev)
    hist[:, 0, 0] = START
    scores = torch.zeros((B, K), device=dev)
    prev = hist[:, :, 0].clone()
    adv = torch.zeros((B,), dtype=torch.long, device=dev)
    eos_top = torch.zeros((B,), dtype=torch.bool, device=dev)
    fin = torch.zeros((B,), dtype=torch.long, device=dev)
    ys, ptrs, scs = [], [], []
    v_ix = torch.arange(V, device=dev)
    k0 = (torch.arange(K, device=dev) == 0)[None, :, None]
    for _ in range(T):
        logits = decode_logits(cfg, params, hist.reshape(B * K, -1), zl,
                               cl)[:, -1]
        logp = torch.log_softmax(logits, -1).reshape(B, K, V)
        wp = torch.where(v_ix == START, NEG, logp)
        early = (adv + 1 < min_length)[:, None, None] & (v_ix == EOS)
        wp = torch.where(early, NEG, wp)
        later = torch.where((prev == EOS)[:, :, None], NEG,
                            wp + scores[:, :, None])
        first = torch.where(k0, wp, float("-inf"))
        cand = torch.where((adv == 0)[:, None, None], first, later)
        cand = torch.where(cand == 0.0, torch.zeros_like(cand), cand)
        best, ids = _topk_lowest(cand.reshape(B, K * V), K)
        next_y, prev_k = ids % V, ids // V
        done = eos_top & (fin >= 1)
        d1 = done[:, None]
        fin = fin + ((next_y == EOS) & ~d1).sum(1)
        eos_top = eos_top | ((next_y[:, 0] == EOS) & ~done)
        scores = torch.where(d1, scores, best)
        prev = torch.where(d1, prev, next_y)
        adv = torch.where(done, adv, adv + 1)
        ys.append(torch.where(d1, PAD, next_y))
        ptrs.append(torch.where(d1, 0, prev_k))
        scs.append(best)
        hist = torch.cat([torch.gather(hist, 1, prev_k[:, :, None].expand(
            -1, -1, hist.shape[2])), next_y[:, :, None]], 2)
    ys, ptrs, scs = (torch.stack(a, 1) for a in (ys, ptrs, scs))  # [B, T, K]
    # the candidates: finished hypotheses in step-major, beam-minor order,
    # then the current beam 0 where none finished
    keyed = torch.cat([torch.where(ys == EOS, scs, float("-inf")).reshape(
        B, T * K), torch.where(fin == 0, scores[:, 0], float("-inf"))[:, None]
    ], 1)
    flat = torch.arange(T * K, device=dev)
    t_all = torch.cat([(flat // K + 1).expand(B, -1), adv[:, None]], 1)
    k_all = torch.cat([(flat % K).expand(B, -1),
                       torch.zeros((B, 1), dtype=torch.long, device=dev)], 1)
    pick = torch.argsort(-keyed, dim=1, stable=True)[:, :1]
    t_end = torch.gather(t_all, 1, pick)[:, 0]
    k = torch.gather(k_all, 1, pick)[:, 0]
    best_score = torch.gather(keyed, 1, pick)[:, 0]
    toks = torch.full((B, T + 1), PAD, dtype=torch.long, device=dev)
    for j in range(T - 1, -1, -1):
        on = (j + 1) <= t_end
        rows = torch.arange(B, device=dev)
        toks[:, j + 1] = torch.where(on, ys[rows, j, k], PAD)
        k = torch.where(on, ptrs[rows, j, k], k)
    toks[:, 0] = torch.where(k == 0, START, PAD)
    return toks, best_score
