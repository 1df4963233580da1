"""The port's latent stack (GMM, logistic heads, Q models) against the JAX
package on the same numpy data and injected draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.latent import density as j_density
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.latent import logreg as j_logreg

from controlled_peptide_generation_tpu_torch.latent import density as t_density
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.latent import logreg as t_logreg

COV_TYPES = ["diag", "tied", "full"]


def _blobs(seed=0, n=300, D=4):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((3, D))
    lab = rng.integers(0, 3, n)
    return (centers[lab] + rng.standard_normal((n, D))).astype(np.float32)


def _to_t(params):
    return t_gmm.GMMParams(*(torch.from_numpy(np.array(a)) for a in params))


@pytest.fixture(scope="module")
def fits():
    """JAX EM fits per covariance type, with the kmeans++/Lloyd init they
    started from (same key)."""
    X = _blobs()
    key = jax.random.PRNGKey(3)
    out = {}
    for cov in COV_TYPES:
        init = j_gmm._lloyd(jnp.asarray(X), j_gmm._kmeanspp(
            key, jnp.asarray(X), 3), 10)
        params, info = j_gmm.fit(key, jnp.asarray(X), 3,
                                 covariance_type=cov)
        out[cov] = (np.array(init), params, info)
    return X, out


@pytest.mark.parametrize("cov", COV_TYPES)
def test_em_from_same_init_matches_jax(fits, cov):
    X, out = fits
    init, params, info = out[cov]
    got, ginfo = t_gmm.em_from_means(torch.from_numpy(X),
                                     torch.from_numpy(init), cov)
    assert ginfo.n_iter == int(info.n_iter)
    assert ginfo.converged == bool(info.converged)
    for g, w in zip(got, params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("cov", COV_TYPES)
def test_sample_and_score_on_injected_draws(fits, cov):
    _, out = fits
    params = out[cov][1]
    key = jax.random.PRNGKey(11)
    n = 64
    want = np.array(j_gmm.sample(key, params, n, cov))
    kc, ke = jax.random.split(key)            # gmm.sample's split order
    comp = jax.random.categorical(kc, jnp.log(params.weights), shape=(n,))
    eps = jax.random.normal(ke, (n, params.means.shape[1]))
    tp = _to_t(params)
    got = t_gmm.sample_from_draws(tp, torch.from_numpy(np.array(comp)),
                                  torch.from_numpy(np.array(eps)), cov)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        t_gmm.score_samples(tp, torch.from_numpy(want), cov).numpy(),
        np.asarray(j_gmm.score_samples(params, jnp.asarray(want), cov)),
        rtol=0, atol=1e-4)
    # the port's own draws: right shape, finite
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(t_gmm.sample(g, tp, n, cov)).all()


@pytest.mark.parametrize("sep", [0.5, 4.0])
def test_logreg_matches_jax(sep):
    """sep=4.0 is near-separable: the sigmoids saturate and the damped
    Newton's line search does the work."""
    rng = np.random.default_rng(int(sep * 10))
    X = rng.standard_normal((400, 6)).astype(np.float32)
    logit = sep * (X[:, 0] - 0.5 * X[:, 1]) + 0.3
    y = (logit + 0.5 * rng.standard_normal(400) > 0).astype(np.float32)
    (jw, jb), _ = j_logreg.fit(jnp.asarray(X), jnp.asarray(y))
    (tw, tb), _ = t_logreg.fit(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(tb), float(jb), rtol=0, atol=1e-4)
    acc_t = float(t_logreg.accuracy(t_logreg.LogRegParams(tw, tb),
                                    torch.from_numpy(X),
                                    torch.from_numpy(y)))
    acc_j = float(j_logreg.accuracy(j_logreg.LogRegParams(jw, jb),
                                    jnp.asarray(X), jnp.asarray(y)))
    assert acc_t == pytest.approx(acc_j, abs=1e-6)


@pytest.mark.parametrize("qname", ["fullQ", "gaussianQ"])
def test_evaluate_nll_on_injected_eps(qname):
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((50, 5)).astype(np.float32)
    lv = (-1.0 + 0.2 * rng.standard_normal((50, 5))).astype(np.float32)
    pts_mu = rng.standard_normal((20, 5)).astype(np.float32)
    pts_lv = np.full((20, 5), -1.2, np.float32)
    jq = getattr(j_density, qname)(mu, lv)
    tq = getattr(t_density, qname)(mu, lv)
    key = jax.random.PRNGKey(9)
    want = j_density.evaluate_nll(jq, (pts_mu, pts_lv), key)
    eps = np.asarray(jax.random.normal(key, (20, 1)))
    got = t_density.evaluate_nll(tq, (pts_mu, pts_lv), eps=eps)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_mogq_fits_and_samples():
    X = _blobs(2, n=200)
    g = torch.Generator().manual_seed(0)
    q = t_density.mogQ(X, np.full_like(X, -2.0), n_components=3,
                       z_num_samples=2, gen=g)
    assert q.info.n_iter >= 1
    assert q._sampler()[0] == "gmm_diag"
    nll_q, nll_p = t_density.evaluate_nll(q, (X, np.full_like(X, -2.0)),
                                          gen=g)
    assert np.isfinite(nll_q) and nll_q < nll_p
