"""The port's losses, dropout layers and schedules against the JAX
package's on the same inputs (numpy draws; the JAX draws of a key are
recreated and handed to the port). rtol 1e-5 / atol 1e-6: fp32 sums in
other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.ops import nn as j_nn
from controlled_peptide_generation_tpu.utils import annealing as j_ann

from controlled_peptide_generation_tpu_torch.config import Bunch
from controlled_peptide_generation_tpu_torch.ops import losses as t_L
from controlled_peptide_generation_tpu_torch.ops import mmd_kernel as t_mk
from controlled_peptide_generation_tpu_torch.ops import nn as t_nn
from controlled_peptide_generation_tpu_torch.utils import annealing as t_ann

TOL = dict(rtol=1e-5, atol=1e-6)
T = torch.from_numpy


def _z(seed, n=8, d=6, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


def test_recon_dec_shifts_targets_and_skips_pad():
    rng = np.random.default_rng(0)
    seqs = rng.integers(4, 13, (6, 9)).astype(np.int32)
    seqs[:, 0] = 2
    for row, n in enumerate((3, 5, 9, 2, 7, 9)):
        if n < 9:
            seqs[row, n] = 3
            seqs[row, n + 1:] = 1
    logits = rng.standard_normal((6, 9, 13)).astype(np.float32)
    want = j_L.recon_dec(jnp.asarray(seqs), jnp.asarray(logits))
    got = t_L.recon_dec(T(seqs), T(logits))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("fn", ["kl_gaussianprior", "kl_gaussian_sharedmu"])
def test_gaussian_kls(fn):
    mu, lv = _z(1), _z(2, scale=0.5)
    want = getattr(j_L, fn)(jnp.asarray(mu), jnp.asarray(lv))
    got = getattr(t_L, fn)(T(mu), T(lv))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("kernel", ["gaussian", "laplace", "energy"])
def test_mmd_kernels_and_the_diag_quirk(kernel):
    z1, z2 = _z(3), _z(4)
    want_k = j_L.compute_mmd_kernel(jnp.asarray(z1), jnp.asarray(z2), 2.0,
                                    kernel)
    got_k = t_mk.compute_mmd_kernel(T(z1), T(z2), 2.0, kernel)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), **TOL)
    want = j_L.mmd_full_kernel(jnp.asarray(z1), jnp.asarray(z2), 2.0, kernel)
    got = t_L.mmd_full_kernel(T(z1), T(z2), 2.0, kernel)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    # the quirk is held: a zeroed diagonal would give another value
    H = (t_mk.compute_mmd_kernel(T(z1), T(z1), 2.0, kernel)
         + t_mk.compute_mmd_kernel(T(z2), T(z2), 2.0, kernel)
         - 2 * got_k)
    zeroed = (H.sum() - H.diagonal().sum()) / (8 * 7)
    assert abs(zeroed.item() - got.item()) > 1e-4


def test_wae_mmd_terms_with_the_jax_prior_draws():
    key = jax.random.PRNGKey(11)
    z = _z(5, n=10, d=4)
    kb, kp = jax.random.split(key)
    rf_w, rf_b = j_L.init_rf_basis(kb, 4, 16)
    z_prior = np.array(jax.random.normal(kp, z.shape, jnp.float32))
    want_full = j_L.wae_mmd_gaussianprior_full(kp, jnp.asarray(z), 7.0)
    want_rf = j_L.wae_mmd_gaussianprior_rf(kp, jnp.asarray(z), rf_w, rf_b,
                                           7.0)
    got_full = t_L.wae_mmd_gaussianprior_full(T(z), 7.0,
                                              z_prior=T(z_prior))
    got_rf = t_L.wae_mmd_gaussianprior_rf(
        T(z), T(np.array(rf_w)), T(np.array(rf_b)), 7.0,
        z_prior=T(z_prior))
    np.testing.assert_allclose(got_full.item(), float(want_full), **TOL)
    np.testing.assert_allclose(got_rf.item(), float(want_rf), **TOL)
    want_emb = j_L._rf_embed(jnp.asarray(z), rf_w, rf_b, 7.0)
    got_emb = t_L._rf_embed(T(z), T(np.array(rf_w)), T(np.array(rf_b)),
                            7.0)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), **TOL)


def test_rf_basis_and_prior_draws_have_the_right_law():
    """The port draws with torch: N(0, 1) weights, U(0, 2 pi) phases."""
    g = torch.Generator().manual_seed(0)
    rf_w, rf_b = t_L.init_rf_basis(g, 50, 400)
    assert rf_w.shape == (50, 400) and rf_b.shape == (400,)
    assert abs(rf_w.mean().item()) < 0.02
    assert abs(rf_w.std().item() - 1) < 0.02
    assert 0 <= rf_b.min().item() and rf_b.max().item() <= 2 * np.pi
    # the prior samples of the WAE terms are N(0, I) draws from ``gen``
    z = torch.randn((16, 3), generator=g)
    state = g.get_state()
    drawn = t_L.wae_mmd_gaussianprior_full(z, 7.0, gen=g)
    given = t_L.wae_mmd_gaussianprior_full(
        z, 7.0, z_prior=torch.randn((16, 3), generator=g.set_state(state)))
    assert drawn.item() == given.item()


def test_dropout_layers_with_the_jax_masks():
    key = jax.random.PRNGKey(2)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 7, 4)).astype(np.float32)
    tok = rng.integers(4, 20, (5, 7)).astype(np.int32)
    want = j_nn.dropout(key, jnp.asarray(x), 0.3, True)
    keep = np.array(jax.random.bernoulli(key, 0.7, x.shape))
    got = t_nn.dropout(T(x), 0.3, True, keep=T(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_t = j_nn.word_dropout(key, jnp.asarray(tok), 0.3, 0, True)
    drop = np.array(jax.random.bernoulli(key, 0.3, tok.shape))
    got_t = t_nn.word_dropout(T(tok), 0.3, 0, True, drop=T(drop))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    # not training, or rate 0: the identity
    np.testing.assert_array_equal(t_nn.dropout(T(x), 0.3, False).numpy(), x)
    np.testing.assert_array_equal(t_nn.dropout(T(x), 0.0, True).numpy(), x)
    np.testing.assert_array_equal(
        t_nn.word_dropout(T(tok), 0.3, 0, False).numpy(), tok)


def test_drawn_dropout_masks_have_the_right_rate():
    g = torch.Generator().manual_seed(1)
    x = torch.ones((200, 500))
    kept = (t_nn.dropout(x, 0.3, True, gen=g) != 0).float().mean().item()
    tok = torch.full((200, 500), 7)
    dropped = (t_nn.word_dropout(tok, 0.3, 0, True, gen=g) == 0)
    assert abs(kept - 0.7) < 0.01
    assert abs(dropped.float().mean().item() - 0.3) < 0.01


@pytest.mark.parametrize("it", [-5, 0, 3, 10, 11, 100])
def test_anneal(it):
    sched = Bunch(start=Bunch(val=1.0, iter=0), end=Bunch(val=2.0, iter=10))
    np.testing.assert_allclose(t_ann.anneal(sched, it),
                               j_ann.anneal(sched, it), rtol=1e-12)
