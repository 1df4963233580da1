"""CLaSS rejection sampling of the serial loop (``hw.fused_rounds=0``).

Draw z ~ Q (a GMM), score every logistic attribute head, multiply the
probabilities of the target classes, and accept where a uniform draw is
below the product. The draws are split from the math, as in
``latent/fused.py``: ``rejection_draws`` takes every random number from a
torch.Generator, and ``rejection_round`` is a function of them, so tests
can inject the JAX package's draws.
"""

from typing import NamedTuple

import torch

from ..parallel import rounds
from . import gmm as gmm_mod


class RejectionDraws(NamedTuple):
    comp: torch.Tensor    # [n] GMM component ids
    eps: torch.Tensor     # [n, D] standard normals
    u: torch.Tensor       # [n] uniforms of the acceptance test


def rejection_draws(gen, q_params, n):
    """Every random number of one rejection round, from ``gen``."""
    comp, eps = gmm_mod.sample_draws(gen, q_params, n)
    u = torch.rand((n,), generator=gen, device=q_params.means.device)
    return RejectionDraws(comp, eps, u)


def clf_args(Q):
    """(names, clf_w [A, D], clf_b [A], targets [A]) of Q's heads."""
    names = sorted(Q.attr_clfs)
    clf_w = torch.stack([Q.attr_clfs[a].w for a in names])
    clf_b = torch.stack([torch.as_tensor(Q.attr_clfs[a].b) for a in names])
    targets = torch.tensor([Q.clf_targets[a] for a in names],
                           device=clf_w.device)
    return names, clf_w, clf_b.to(clf_w.device), targets


def rejection_round(draws, sampler, clf_w, clf_b, targets):
    """sampler: ('gmm_diag'|'gmm_tied'|'gmm_full', GMMParams); clf_w
    [A, D], clf_b [A], targets [A] in {0, 1}. Returns (z [n, D], probs
    [n, A] of each head's target class, accum [n] their product, accept
    [n] bool)."""
    kind, q_params = sampler
    z = gmm_mod.sample_from_draws(q_params, draws.comp, draws.eps,
                                  kind.split("_", 1)[1])
    p1 = torch.sigmoid(z @ clf_w.T + clf_b[None, :])
    probs = torch.where(targets[None, :] == 1, p1, 1.0 - p1)
    accum = torch.prod(probs, dim=1)
    return z, probs, accum, draws.u < accum


def round_scores(names, Q, accum, probs, prefix="clfZ"):
    """A round's score columns: ``<prefix>_prob_accum`` and
    ``<prefix>_<attr>=<target>`` of each head."""
    scores = {f"{prefix}_prob_accum": accum}
    for i, a in enumerate(names):
        scores[f"{prefix}_{a}={Q.clf_targets[a]}"] = probs[:, i]
    return scores


def sample_round(devices, draws, Q):
    """``rejection_round`` of Q's sampler and heads on ``draws`` over
    ``devices`` (the JAX package's ``dp_rejection_round``; one device is a
    list of one): each device scores its n / D rows. Returns (z, scores
    dict, accept) joined on the draws' device."""
    n, home = draws.u.shape[0], draws.u.device
    rounds.check(n, devices)
    names, clf_w, clf_b, targets = clf_args(Q)
    kind, q_params = Q._sampler()
    heads = (q_params, clf_w, clf_b, targets)
    outs = []
    for d, dev in zip(rounds.split(draws, devices), devices):
        q, w, b, t = rounds.to(heads, dev)
        outs.append(rejection_round(d, (kind, q), w, b, t))
    z, probs, accum, accept = (rounds.join([o[j] for o in outs], home)
                               for j in range(4))
    return z, round_scores(names, Q, accum, probs), accept


def accepted_z(z, accept, max_accepted):
    """Up to ``max_accepted`` accepted rows gathered into a fixed-shape
    buffer (row 0 fills the slots past the accepted ones), and their
    count."""
    idx = torch.nonzero(accept).flatten()[:max_accepted]
    pad = max_accepted - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    count = torch.clamp(accept.sum(), max=max_accepted)
    return z[idx], count
