"""One CLaSS round: rejection sampling + beam decode.

A round draws latents from Q(z), scores every classifier head, accepts
with probability equal to the product of the head probabilities, draws c
from its prior and beam-decodes (beam 5, top-1 kept) - every candidate
(capacity=None, the reference semantics) or only the accepted ones,
compacted to the front of a fixed-capacity batch (capacity=K; the accepted
output set is identical to the decode-all round's accepted subset).

The draws are split from the math: ``round_draws`` takes every random
number of a round from a torch.Generator, and ``_round_body`` is a
function of those draws, so tests can inject the JAX package's draws.
"""

from typing import NamedTuple

import torch

from ..ops import nn
from ..ops.beam import beam_search
from . import class_sampler
from . import gmm as gmm_mod

# max sentences per beam_search call inside a round
_BEAM_CHUNK = 25_000


class RoundDraws(NamedTuple):
    comp: torch.Tensor    # [n] GMM component ids
    eps: torch.Tensor     # [n, D] standard normals
    u: torch.Tensor       # [n] uniforms of the acceptance test
    cbit: torch.Tensor    # [n] bool, c = one_hot(cbit)


def round_draws(gen, q_params, n):
    """Every random number of one round, from ``gen``."""
    comp, eps = gmm_mod.sample_draws(gen, q_params, n)
    dev = q_params.means.device
    u = torch.rand((n,), generator=gen, device=dev)
    cbit = torch.rand((n,), generator=gen, device=dev) < 0.5
    return RoundDraws(comp, eps, u, cbit)


def _round_body(model, params, draws, kind, q_params, clf_w, clf_b, targets,
                beam_size=5, decode_dtype="float32", capacity=None,
                beam_chunk=None, plain=False):
    """The round as a function of its draws.

    capacity=None decodes all n candidates and returns a 6-tuple
    (z, c, probs, accum, accept, tokens [n, T+1]); capacity=K compacts the
    accepted latents to the front (stable sort on the accept mask) and
    decodes only K slots, returning (..., idx, valid) where idx[j] is the
    candidate in slot j and valid[j] marks a real accepted candidate; z,
    probs and accum are then the K gathered rows."""
    n = draws.u.shape[0]
    # rejection math stays fp32
    z, probs, accum, accept = class_sampler.rejection_round(
        class_sampler.RejectionDraws(draws.comp, draws.eps, draws.u),
        (kind, q_params), clf_w, clf_b, targets)
    c = model.c_from_bits(draws.cbit)
    z_dec = model.apply_flow(params, z)[0]
    idx = valid = None
    if capacity is not None:
        capacity = min(int(capacity), n)
        idx = torch.argsort((~accept).to(torch.int8), stable=True)[:capacity]
        valid = torch.arange(capacity, device=z.device) < accept.sum()
        z, probs, accum = z[idx], probs[idx], accum[idx]
        z_dec, c = z_dec[idx], c[idx]
    dt = getattr(torch, decode_dtype)
    dec_params = params if dt == torch.float32 else nn.cast_tree(params, dt)
    z_d, c_d = z_dec.to(dt), c.to(dt)
    beam_chunk = _BEAM_CHUNK if beam_chunk is None else int(beam_chunk)
    parts = [beam_search(model, dec_params, z_d[s:s + beam_chunk],
                         c_d[s:s + beam_chunk], beam_size=beam_size,
                         n_best=1, plain=plain)[0][:, 0, :]
             for s in range(0, z_d.shape[0], beam_chunk)]
    tokens = torch.cat(parts) if len(parts) != 1 else parts[0]
    if capacity is None:
        return z, c, probs, accum, accept, tokens
    return z, c, probs, accum, accept, tokens, idx, valid


def fused_round(model, params, draws, Q, beam_size=5, prefix="clfZ",
                decode_dtype="float32", capacity=None, beam_chunk=None,
                plain=False):
    """One round from its draws: returns (z, scores dict, accept,
    tokens [n, T+1]); with capacity=K, (z, scores, accept, tokens [K, T+1],
    idx [K], valid [K]) with z/scores on the K compacted rows. plain=True
    decodes with the beam kernel's plain version (for comparisons only)."""
    names, clf_w, clf_b, targets = class_sampler.clf_args(Q)
    kind, q_params = Q._sampler()
    out = _round_body(model, params, draws, kind, q_params, clf_w, clf_b,
                      targets, beam_size, decode_dtype, capacity,
                      beam_chunk, plain)
    z, c, probs, accum, accept, tokens = out[:6]
    scores = {f"{prefix}_prob_accum": accum}
    for i, a in enumerate(names):
        scores[f"{prefix}_{a}={Q.clf_targets[a]}"] = probs[:, i]
    if capacity is None:
        return z, scores, accept, tokens
    return z, scores, accept, tokens, out[6], out[7]
