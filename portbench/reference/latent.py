"""CLaSS's latent layer, plainly: the mixture Q(z) fitted by EM from a
kmeans++ seeding, a round's random draws, and the attribute heads' accept
test.

The fit follows scikit-learn's GaussianMixture with diagonal covariances
(kmeans++ seeding refined by Lloyd iterations, reg_covar on the variances,
a stop when the mean log-likelihood moves less than ``tol``); its draws
come from a ``torch.Generator`` in a fixed order, so a fit, and each
round, replays from its seed.
"""

import math
from typing import NamedTuple

import torch

LOG2PI = math.log(2.0 * math.pi)


class Mixture(NamedTuple):
    weights: torch.Tensor   # [K]
    means: torch.Tensor     # [K, D]
    covars: torch.Tensor    # [K, D], diagonal


def log_prob_components(q, X):
    """log N(x; mean_k, diag(covar_k)) for every row and component: [N, K]."""
    prec = 1.0 / q.covars
    logdet = torch.log(q.covars).sum(1)
    quad = (X ** 2 @ prec.T - 2.0 * (X @ (q.means * prec).T)
            + (q.means ** 2 * prec).sum(1)[None, :])
    return -0.5 * (X.shape[1] * LOG2PI + logdet[None, :] + quad)


def kmeanspp(X, K, gen):
    """K seeds: a uniform first row, then rows drawn in proportion to
    their squared distance to the nearest seed so far."""
    N = X.shape[0]
    first = torch.randint(0, N, (1,), generator=gen, device=X.device)
    means = torch.zeros((K, X.shape[1]), dtype=X.dtype, device=X.device)
    means[0] = X[first[0]]
    dist = ((X - means[0][None, :]) ** 2).sum(1)
    for i in range(1, K):
        idx = torch.multinomial(torch.clamp(dist, min=1e-30), 1,
                                generator=gen)
        means[i] = X[idx[0]]
        dist = torch.minimum(dist, ((X - means[i][None, :]) ** 2).sum(1))
    return means


def lloyd(X, means, n_iter):
    """Lloyd's k-means iterations; an empty cluster keeps its mean."""
    K = means.shape[0]
    x2 = (X ** 2).sum(1)[:, None]
    for _ in range(n_iter):
        d = x2 - 2 * X @ means.T + (means ** 2).sum(1)[None, :]
        A = torch.nn.functional.one_hot(d.argmin(1), K).to(X.dtype)
        counts = A.sum(0)
        means = torch.where(counts[:, None] > 0,
                            (A.T @ X) / counts.clamp(min=1.0)[:, None],
                            means)
    return means


def fit(X, K, gen, max_iter=100, tol=1e-3, reg_covar=1e-6, kmeans_iters=10):
    """EM for a K-component diagonal mixture from a kmeans++ + Lloyd
    start."""
    means = lloyd(X, kmeanspp(X, K, gen), kmeans_iters)
    var0 = X.var(0, unbiased=False) + reg_covar
    q = Mixture(torch.full((K,), 1.0 / K, dtype=X.dtype, device=X.device),
                means, var0[None, :].repeat(K, 1))
    eps = 10 * torch.finfo(X.dtype).eps
    lb_prev, n_iter, converged = -math.inf, 0, False
    while not converged and n_iter < max_iter:
        wlp = log_prob_components(q, X) + torch.log(q.weights)[None, :]
        norm = torch.logsumexp(wlp, 1, keepdim=True)
        lb = float(norm.mean())
        resp = torch.exp(wlp - norm)
        nk = resp.sum(0) + eps
        means = (resp.T @ X) / nk[:, None]
        covars = (resp.T @ X ** 2) / nk[:, None] - means ** 2 + reg_covar
        q = Mixture(nk / X.shape[0], means, covars.clamp(min=reg_covar))
        n_iter += 1
        converged = abs(lb - lb_prev) < tol
        lb_prev = lb
    return q


def fit_mogQ(mu, logvar, K, z_num_samples, gen):
    """Q of the CLaSS reference: a mixture fitted to z_num_samples
    reparameterized draws of every encoder output (mu, logvar [N, D])."""
    eps = torch.randn((z_num_samples,) + tuple(mu.shape), generator=gen,
                      device=mu.device)
    z = (mu[None] + torch.exp(0.5 * logvar)[None] * eps).reshape(
        -1, mu.shape[1])
    return fit(z, K, gen)


class RoundDraws(NamedTuple):
    comp: torch.Tensor    # [n] component ids
    eps: torch.Tensor     # [n, D] standard normals
    u: torch.Tensor       # [n] uniforms of the accept test
    cbit: torch.Tensor    # [n] c = one_hot(cbit)


def round_draws(gen, q, n):
    """A round's draws, in their order: components, normals, the accept
    uniforms, the c bits."""
    comp = torch.multinomial(q.weights, n, replacement=True, generator=gen)
    eps = torch.randn((n, q.means.shape[1]), generator=gen,
                      device=q.means.device, dtype=q.means.dtype)
    u = torch.rand((n,), generator=gen, device=q.means.device)
    cbit = torch.rand((n,), generator=gen, device=q.means.device) < 0.5
    return RoundDraws(comp, eps, u, cbit)


def sample(q, draws):
    """z = mean + sqrt(covar) * eps of each drawn component."""
    return q.means[draws.comp] + torch.sqrt(q.covars[draws.comp]) * draws.eps


def heads(z, w, b, targets):
    """The logistic heads' probabilities of their target classes [n, A],
    and their product [n]."""
    p1 = torch.sigmoid(z @ w.T + b[None, :])
    probs = torch.where(targets[None, :] == 1, p1, 1.0 - p1)
    return probs, probs.prod(1)
