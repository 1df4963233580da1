"""Latent density models Q(z) for CLaSS.

Three estimators over encoder outputs (mu, logvar):

* mogQ      - GMM over reparameterized samples, fit by EM (latent/gmm.py);
* fullQ     - exact mixture of N diagonal Gaussians, one per data point;
* gaussianQ - single Gaussian with covar = Cov(mu) + diag(E[var]).

Plus prior_logpdf and evaluate_nll, keeping the reference's quirk of adding
the SAME scalar noise to every z dimension per evaluation point.
"""

import math

import torch

from . import class_sampler
from . import gmm as gmm_mod

TAU = 2.0 * math.pi


def prior_logpdf(z):
    """log N(z; 0, I) for [N, D] (or [D]) rows."""
    z = torch.atleast_2d(z)
    return -0.5 * z.shape[1] * math.log(TAU) - 0.5 * torch.sum(z ** 2, dim=1)


def empirical_covar(X):
    Xc = X - X.mean(0, keepdim=True)
    return (Xc.T @ Xc) / X.shape[0]


def _as_f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


class RejSampleMixin:
    """Attribute-classifier plumbing shared by the Q models."""

    def init_attr_classifiers(self, attr_clfs, clf_targets):
        self.attr_clfs = dict(attr_clfs)       # name -> LogRegParams
        self.clf_targets = dict(clf_targets)   # name -> target column {0,1}

    def rejection_sample(self, gen, n_samples, draws=None):
        """Sample z ~ Q, score every head, accept where U < prod(p), from
        ``gen`` (or the injected ``class_sampler.RejectionDraws``).
        Returns (z, scores dict, accept): scores are ``clfZ_prob_accum``
        and ``clfZ_<attr>=<target>``."""
        if draws is None:
            draws = class_sampler.rejection_draws(gen, self.params,
                                                  n_samples)
        return class_sampler.sample_round([draws.u.device], draws, self)

    def _sampler(self):
        """(kind, GMMParams) consumed by the rounds."""
        return ("gmm_" + self.covariance_type, self.params)

    def logpdf(self, x):
        x = torch.atleast_2d(_as_f32(x, self.params.means.device))
        return gmm_mod.score_samples(self.params, x, self.covariance_type)


class mogQ(RejSampleMixin):
    """GMM fit to z_num_samples reparameterized draws per encoder output."""

    def __init__(self, mu, logvar, n_components=100, z_num_samples=10,
                 covariance_type="diag", gen=None, max_iter=100, tol=1e-3,
                 reg_covar=1e-6, device="cpu"):
        mu = _as_f32(mu, device)
        logvar = _as_f32(logvar, device)
        eps = torch.randn((z_num_samples,) + tuple(mu.shape), generator=gen,
                          device=mu.device)
        z = (mu[None] + torch.exp(0.5 * logvar)[None] * eps).reshape(
            -1, mu.shape[1])
        self.covariance_type = covariance_type
        self.params, self.info = gmm_mod.fit(
            z, n_components, covariance_type=covariance_type,
            max_iter=max_iter, tol=tol, reg_covar=reg_covar, gen=gen)
        self.n_components = n_components


class fullQ(RejSampleMixin):
    """Exact mixture of N diagonal Gaussians (one per training point)."""

    def __init__(self, mu, logvar, device="cpu"):
        mu = _as_f32(mu, device)
        logvar = _as_f32(logvar, device)
        n = mu.shape[0]
        self.params = gmm_mod.GMMParams(
            weights=torch.full((n,), 1.0 / n, device=mu.device),
            means=mu, covars=torch.exp(logvar))
        self.covariance_type = "diag"


class gaussianQ(RejSampleMixin):
    """Single Gaussian: mean(mu), covar = Cov(mu) (+ diag mean enc var)."""

    def __init__(self, mu, logvar, covar_add_encoder_vars=True, device="cpu"):
        mu = _as_f32(mu, device)
        logvar = _as_f32(logvar, device)
        covar = empirical_covar(mu)
        if covar_add_encoder_vars:
            covar = covar + torch.diag(torch.exp(logvar).mean(0))
        self.params = gmm_mod.GMMParams(
            weights=torch.ones((1,), device=mu.device),
            means=mu.mean(0, keepdim=True), covars=covar[None])
        self.covariance_type = "full"


def evaluate_nll(q, points, gen=None, eps=None):
    """NLL of heldout encoder outputs under Q(z) and under the prior.

    points: (mu [N,D], logvar [N,D]). The reparameterization noise is a
    single scalar per point, broadcast over all z dims; pass ``eps``
    [N, 1] to inject it, else it is drawn from ``gen``."""
    dev = q.params.means.device
    mu, lv = (_as_f32(a, dev) for a in points)
    if eps is None:
        eps = torch.randn((mu.shape[0], 1), generator=gen, device=dev)
    z = mu + torch.exp(0.5 * lv) * _as_f32(eps, dev)
    nll_q = -torch.mean(q.logpdf(z))
    nll_p = -torch.mean(prior_logpdf(z))
    return float(nll_q), float(nll_p)
