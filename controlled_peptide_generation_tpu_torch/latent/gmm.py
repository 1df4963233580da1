"""Gaussian-mixture EM on the device.

E-step as [N, K] matmul-shaped contractions plus a logsumexp, M-step as
resp.T @ X moment products; 'diag', 'tied' and 'full' covariances;
kmeans++ seeding with Lloyd refinement; sklearn's reg_covar jitter and
|delta mean log-likelihood| < tol stopping rule. Matmuls run in full fp32
(utils/runtime.set_full_fp32: no TF32).

Random draws come from an explicit torch.Generator; ``sample_draws`` and
``sample_from_draws`` split a draw from its math so tests can inject the
JAX package's draws.
"""

import math
from typing import NamedTuple

import torch

LOG2PI = 1.8378770664093453


class GMMParams(NamedTuple):
    weights: torch.Tensor   # [K]
    means: torch.Tensor     # [K, D]
    covars: torch.Tensor    # diag: [K, D]; tied: [D, D]; full: [K, D, D]


class GMMFitInfo(NamedTuple):
    converged: bool
    n_iter: int
    lower_bound: float


# ---------------------------------------------------------------------------
# log densities
# ---------------------------------------------------------------------------

def _log_prob_diag(X, means, covars):
    """[N,D],[K,D],[K,D] -> [N,K] component log densities."""
    prec = 1.0 / covars
    logdet = torch.sum(torch.log(covars), dim=1)
    quad = (X ** 2 @ prec.T
            - 2.0 * (X @ (means * prec).T)
            + torch.sum(means ** 2 * prec, dim=1)[None, :])
    return -0.5 * (X.shape[1] * LOG2PI + logdet[None, :] + quad)


def _log_prob_full(X, means, covars):
    """[N,D],[K,D],[K,D,D] -> [N,K]."""
    chol = torch.linalg.cholesky(covars)                          # [K,D,D]
    diff = (X[None, :, :] - means[:, None, :]).transpose(1, 2)    # [K,D,N]
    y = torch.linalg.solve_triangular(chol, diff, upper=False)
    quad = torch.sum(y ** 2, dim=1)                               # [K,N]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)),
                             dim=1)
    return (-0.5 * (X.shape[1] * LOG2PI + logdet[:, None] + quad)).T


def _log_prob_tied(X, means, covar):
    """[N,D],[K,D],[D,D] -> [N,K]: one shared covariance, one Cholesky."""
    L = torch.linalg.cholesky(covar)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    Xw = torch.linalg.solve_triangular(L, X.T, upper=False).T
    Mw = torch.linalg.solve_triangular(L, means.T, upper=False).T
    quad = (torch.sum(Xw ** 2, 1)[:, None] - 2.0 * Xw @ Mw.T
            + torch.sum(Mw ** 2, 1)[None, :])
    return -0.5 * (X.shape[1] * LOG2PI + logdet + quad)


_LOG_PROB = {"diag": _log_prob_diag, "tied": _log_prob_tied,
             "full": _log_prob_full}


def log_prob_components(params, X, covariance_type):
    try:
        fn = _LOG_PROB[covariance_type]
    except KeyError:
        raise ValueError(
            f"unknown covariance_type {covariance_type!r}; "
            f"expected one of {sorted(_LOG_PROB)}") from None
    return fn(X, params.means, params.covars)


def score_samples(params, X, covariance_type="diag"):
    """Per-sample log p(x) under the mixture (sklearn score_samples)."""
    lp = log_prob_components(params, X, covariance_type)
    return torch.logsumexp(lp + torch.log(params.weights)[None, :], dim=1)


# ---------------------------------------------------------------------------
# init: kmeans++ seeding (+ Lloyd refinement)
# ---------------------------------------------------------------------------

def kmeanspp(X, K, gen):
    N = X.shape[0]
    first = torch.randint(0, N, (1,), generator=gen, device=X.device)
    means = torch.zeros((K, X.shape[1]), dtype=X.dtype, device=X.device)
    means[0] = X[first[0]]
    dist = torch.sum((X - means[0][None, :]) ** 2, dim=1)
    for i in range(1, K):
        idx = torch.multinomial(torch.clamp(dist, min=1e-30), 1,
                                generator=gen)
        means[i] = X[idx[0]]
        dist = torch.minimum(dist, torch.sum((X - means[i][None, :]) ** 2,
                                             dim=1))
    return means


def lloyd(X, means, n_iter):
    K = means.shape[0]
    x2 = torch.sum(X ** 2, 1)[:, None]
    for _ in range(n_iter):
        d = x2 - 2 * X @ means.T + torch.sum(means ** 2, 1)[None, :]
        A = torch.nn.functional.one_hot(torch.argmin(d, dim=1), K).to(X.dtype)
        counts = A.sum(0)
        sums = A.T @ X
        means = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts, min=1.0)[:, None],
                            means)
    return means


# ---------------------------------------------------------------------------
# EM
# ---------------------------------------------------------------------------

def _eps(X):
    return 10 * torch.finfo(X.dtype).eps


def _m_step_diag(X, log_resp, reg_covar):
    resp = torch.exp(log_resp)
    nk = resp.sum(0) + _eps(X)
    means = (resp.T @ X) / nk[:, None]
    ex2 = (resp.T @ (X ** 2)) / nk[:, None]
    covars = ex2 - means ** 2 + reg_covar
    return GMMParams(nk / X.shape[0], means,
                     torch.clamp(covars, min=reg_covar))


def _m_step_tied(X, log_resp, reg_covar):
    resp = torch.exp(log_resp)
    nk = resp.sum(0) + _eps(X)
    means = (resp.T @ X) / nk[:, None]
    avg_X2 = X.T @ X
    avg_means2 = (means * nk[:, None]).T @ means
    covar = (avg_X2 - avg_means2) / nk.sum()
    covar = covar + reg_covar * torch.eye(X.shape[1], dtype=X.dtype,
                                          device=X.device)
    return GMMParams(nk / X.shape[0], means, covar)


def _m_step_full(X, log_resp, reg_covar):
    resp = torch.exp(log_resp)
    nk = resp.sum(0) + _eps(X)
    means = (resp.T @ X) / nk[:, None]
    diff = X[None, :, :] - means[:, None, :]                      # [K,N,D]
    covars = (diff * resp.T[:, :, None]).transpose(1, 2) @ diff
    covars = covars / nk[:, None, None]
    covars = covars + reg_covar * torch.eye(X.shape[1], dtype=X.dtype,
                                            device=X.device)
    return GMMParams(nk / X.shape[0], means, covars)


_M_STEP = {"diag": _m_step_diag, "tied": _m_step_tied, "full": _m_step_full}


def em_from_means(X, means, covariance_type="diag", max_iter=100, tol=1e-3,
                  reg_covar=1e-6):
    """EM from given initial means (uniform weights, var(X) covariances).
    Returns (GMMParams, GMMFitInfo)."""
    if covariance_type not in _M_STEP:
        raise ValueError(f"unknown covariance_type {covariance_type!r}")
    K, D = means.shape
    var0 = torch.var(X, dim=0, unbiased=False) + reg_covar
    if covariance_type == "diag":
        covars = var0[None, :].repeat(K, 1)
    elif covariance_type == "tied":
        covars = torch.diag(var0)
    else:
        covars = torch.diag(var0)[None].repeat(K, 1, 1)
    params = GMMParams(torch.full((K,), 1.0 / K, dtype=X.dtype,
                                  device=X.device), means, covars)
    m_step = _M_STEP[covariance_type]
    lb_prev = -math.inf
    lb = lb_prev
    n_iter, converged = 0, False
    while not converged and n_iter < max_iter:
        wlp = (log_prob_components(params, X, covariance_type)
               + torch.log(params.weights)[None, :])
        norm = torch.logsumexp(wlp, dim=1, keepdim=True)
        lb = float(torch.mean(norm))
        params = m_step(X, wlp - norm, reg_covar)
        n_iter += 1
        converged = abs(lb - lb_prev) < tol
        lb_prev = lb
    return params, GMMFitInfo(converged, n_iter, lb)


def fit(X, n_components, covariance_type="diag", max_iter=100, tol=1e-3,
        reg_covar=1e-6, kmeans_iters=10, gen=None):
    """Fit by EM from a kmeans++ (+ Lloyd) init drawn from ``gen``.
    Returns (GMMParams, GMMFitInfo)."""
    means = kmeanspp(X, n_components, gen)
    if kmeans_iters:
        means = lloyd(X, means, kmeans_iters)
    return em_from_means(X, means, covariance_type, max_iter, tol, reg_covar)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_draws(gen, params, n):
    """The random part of a draw: (component ids [n], eps [n, D])."""
    comp = torch.multinomial(params.weights, n, replacement=True,
                             generator=gen)
    eps = torch.randn((n, params.means.shape[1]), generator=gen,
                      device=params.means.device, dtype=params.means.dtype)
    return comp, eps


def sample_from_draws(params, comp, eps, covariance_type="diag"):
    """The math of a draw: n samples from components and standard
    normal eps."""
    mu = params.means[comp]
    if covariance_type == "diag":
        return mu + torch.sqrt(params.covars[comp]) * eps
    if covariance_type == "tied":
        return mu + eps @ torch.linalg.cholesky(params.covars).T
    chol = torch.linalg.cholesky(params.covars)[comp]             # [n,D,D]
    return mu + torch.einsum("nij,nj->ni", chol, eps)


def sample(gen, params, n, covariance_type="diag"):
    """Draw n samples: categorical component + gaussian."""
    comp, eps = sample_draws(gen, params, n)
    return sample_from_draws(params, comp, eps, covariance_type)
