"""One CLaSS round: rejection sampling + beam decode.

A round draws latents from Q(z), scores every classifier head, accepts
with probability equal to the product of the head probabilities, draws c
from its prior and beam-decodes flow(z) (the identity without a flow;
the returned z stays the raw draw) with beam 5, top-1 kept: every
candidate (capacity=None, the reference semantics) or only the accepted
ones, compacted to the front of a fixed-capacity batch (capacity=K; the
accepted output set is identical to the decode-all round's accepted
subset; the deconv family's batch norm reads all K slots, the invalid
ones too, as the JAX round's does). The GRU family decodes in the beam
kernel B1 on the card where its scope covers the model, else (skip
connections) in the plain beam, as the JAX round routes; the deconv
family replays its logits in ``beam_search_logits``.

The draws are split from the math: ``round_draws`` takes every random
number of a round from a torch.Generator, and ``_round_body`` is a
function of those draws, so tests can inject the JAX package's draws.
A round runs over a device list (``parallel/rounds.py``; one device is a
list of one): n / D candidates a device, the same tokens and accept masks
as on one device, as the JAX package's ``dp_fused_round``.
"""

from typing import NamedTuple

import torch

from ..ops import nn
from ..ops.beam import beam_search, beam_search_logits, in_kernel_scope
from ..parallel import rounds
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


def _score(model, params, draws, kind, q_params, clf_w, clf_b, targets):
    """The round's rejection math, per row: (z, c, probs, accum, accept,
    z_dec = flow(z))."""
    # rejection math stays fp32
    z, probs, accum, accept = class_sampler.rejection_round(
        class_sampler.RejectionDraws(draws.comp, draws.eps, draws.u),
        (kind, q_params), clf_w, clf_b, targets)
    c = model.c_from_bits(draws.cbit)
    return z, c, probs, accum, accept, model.apply_flow(params, z)[0]


def _compact(accept, capacity):
    """The accepted-first stable order's first ``capacity`` candidates
    (idx) and which of them are accepted (valid)."""
    idx = torch.argsort((~accept).to(torch.int8), stable=True)[:capacity]
    valid = torch.arange(capacity, device=accept.device) < accept.sum()
    return idx, valid


def _decode(model, params, z_dec, c, beam_size=5, decode_dtype="float32",
            beam_chunk=None, plain=False):
    """Beam-decode (z_dec, c) in chunks of ``beam_chunk``: tokens [n,
    T+1], top-1."""
    dt = getattr(torch, decode_dtype)
    dec_params = params if dt == torch.float32 else nn.cast_tree(params, dt)
    z_d, c_d = z_dec.to(dt), c.to(dt)
    beam_chunk = _BEAM_CHUNK if beam_chunk is None else int(beam_chunk)
    # outside the beam kernel's scope (skip connections) the plain beam,
    # as the JAX package's round decodes such models in its XLA arm
    plain = plain or not in_kernel_scope(model, dec_params, z_d, beam_size)

    def decode(z_i, c_i):
        if model.G_class == "deconv":
            # all logits from (z, c) at once, replayed by the beam; batch
            # norm reads the chunk's rows together, as in the JAX round
            return beam_search_logits(model.decode_logits(dec_params, z_i,
                                                          c_i),
                                      beam_size=beam_size, n_best=1)[0]
        return beam_search(model, dec_params, z_i, c_i, beam_size=beam_size,
                           n_best=1, plain=plain)[0]

    parts = [decode(z_d[s:s + beam_chunk], c_d[s:s + beam_chunk])[:, 0, :]
             for s in range(0, z_d.shape[0], beam_chunk)]
    return torch.cat(parts) if len(parts) != 1 else parts[0]


def _round_body(model, shards, draws, kind, q_params, clf_w, clf_b,
                targets, beam_size=5, decode_dtype="float32", capacity=None,
                beam_chunk=None, plain=False):
    """The round as a function of its draws, over the devices of
    ``shards`` (``parallel.rounds.Shards``, one entry for one device):
    each device scores its n / D rows, and the rows are joined in device
    order on the draws' device.

    capacity=None decodes all n candidates, n / D a device, and returns a
    6-tuple (z, c, probs, accum, accept, tokens [n, T+1]); capacity=K
    compacts the accepted latents to the front (stable sort on the joined
    accept mask) and decodes only K slots, K / D a device, returning (...,
    idx, valid) where idx[j] is the candidate in slot j and valid[j]
    marks a real accepted candidate; z, probs and accum are then the K
    gathered rows. plain=True decodes in the beam kernel's plain version
    (for comparisons)."""
    n = draws.u.shape[0]
    devices, home = shards.devices, draws.u.device
    rounds.check(n, devices, capacity)
    heads = (q_params, clf_w, clf_b, targets)
    scored = [_score(model, p, d, kind, *rounds.to(heads, dev))
              for p, d, dev in zip(shards.replicas,
                                   rounds.split(draws, devices), devices)]
    z, c, probs, accum, accept, z_dec = (
        rounds.join([s[j] for s in scored], home) for j in range(6))
    idx = valid = None
    if capacity is not None:
        idx, valid = _compact(accept, min(int(capacity), n))
        z, probs, accum = z[idx], probs[idx], accum[idx]
        z_dec, c = z_dec[idx], c[idx]
    tokens = rounds.join([
        _decode(model, p, z_i, c_i, beam_size, decode_dtype, beam_chunk,
                plain)
        for p, z_i, c_i in zip(shards.replicas, rounds.split(z_dec, devices),
                               rounds.split(c, devices))], home)
    if capacity is None:
        return z, c, probs, accum, accept, tokens
    return z, c, probs, accum, accept, tokens, idx, valid


def fused_round(model, shards, draws, Q, beam_size=5, prefix="clfZ",
                decode_dtype="float32", capacity=None, beam_chunk=None,
                plain=False):
    """One round from its draws over the devices of ``shards``: returns
    (z, scores dict, accept, tokens [n, T+1]); with capacity=K, (z,
    scores, accept, tokens [K, T+1], idx [K], valid [K]) with z/scores on
    the K compacted rows. plain=True decodes with the beam kernel's plain
    version (for comparisons only)."""
    names, clf_w, clf_b, targets = class_sampler.clf_args(Q)
    kind, q_params = Q._sampler()
    out = _round_body(model, shards, draws, kind, q_params, clf_w, clf_b,
                      targets, beam_size, decode_dtype, capacity,
                      beam_chunk, plain)
    z, c, probs, accum, accept, tokens = out[:6]
    scores = class_sampler.round_scores(names, Q, accum, probs, prefix)
    if capacity is None:
        return z, scores, accept, tokens
    return z, scores, accept, tokens, out[6], out[7]
