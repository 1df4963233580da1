"""The port's fused CLaSS round against the JAX package's ``_round_body``
with the JAX round's own draws injected (same split sequence as
latent/fused.py, latent/gmm.py:sample and models/rnn_vae.py:
sample_c_prior): accept, compaction and tokens equal exactly; probs and
accum to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.latent import fused as j_fused
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.parallel.rounds import shards_of
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

N = 64


def _small(C):
    cfg = C.default_config()
    cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = 12, 10, 8
    return cfg


@pytest.fixture(scope="module")
def setup():
    jm = j_build(_small(JC).model, n_vocab=13, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(1))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(_small(TC).model, n_vocab=13, max_seq_len=10)
    rng = np.random.default_rng(4)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, 12)).astype(np.float32),
         (0.5 + rng.random((4, 12))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, 12))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    return jm, jp, tm, t_ck.params_from_jax(flat), q, heads


def _jax_draws(key, q, n):
    kz, ku, kc = jax.random.split(key, 3)
    kcomp, keps = jax.random.split(kz)
    comp = jax.random.categorical(kcomp, jnp.log(jnp.asarray(q[0])),
                                  shape=(n,))
    eps = jax.random.normal(keps, (n, q[1].shape[1]))
    u = jax.random.uniform(ku, (n,))
    cbit = jax.random.bernoulli(kc, 0.5, (n,))
    T = lambda a: torch.from_numpy(np.array(a))
    return t_fused.RoundDraws(T(comp), T(eps), T(u), T(cbit))


@pytest.mark.parametrize("capacity,beam_chunk",
                         [(None, None), (20, None), (None, 24)])
def test_round_matches_jax(setup, capacity, beam_chunk):
    jm, jp, tm, tp, q, heads = setup
    key = jax.random.PRNGKey(17)
    jq = j_gmm.GMMParams(*map(jnp.asarray, q))
    want = j_fused._fused_round(
        jm, jp, key, "gmm_diag", jq, *map(jnp.asarray, heads), N,
        beam_size=5, decode_dtype="float32", capacity=capacity,
        beam_chunk=beam_chunk)
    want = [np.asarray(a) for a in want]
    tq = t_gmm.GMMParams(*map(torch.from_numpy, q))
    got = t_fused._round_body(
        tm, shards_of(tp), _jax_draws(key, q, N), "gmm_diag", tq,
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32",
        capacity=capacity, beam_chunk=beam_chunk)
    got = [a.numpy() for a in got]
    z, c, probs, accum, accept, tokens = range(6)
    np.testing.assert_allclose(got[z], want[z], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_allclose(got[probs], want[probs], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[accum], want[accum], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[accept], want[accept])
    np.testing.assert_array_equal(got[tokens], want[tokens])
    assert 0 < want[accept].sum() < N          # both branches exercised
    if capacity is not None:
        np.testing.assert_array_equal(got[6], want[6])     # idx
        np.testing.assert_array_equal(got[7], want[7])     # valid


def test_round_draws_from_generator(setup):
    _, _, tm, tp, q, heads = setup
    tq = t_gmm.GMMParams(*map(torch.from_numpy, q))
    d1 = t_fused.round_draws(torch.Generator().manual_seed(5), tq, N)
    d2 = t_fused.round_draws(torch.Generator().manual_seed(5), tq, N)
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert d1.eps.shape == (N, 12) and d1.comp.max() < 4


@pytest.fixture(scope="module")
def tfm_setup(setup):
    """The transformer family at the small size, parameters from JAX."""
    def small(C):
        cfg = _small(C)
        cfg.model.E_args.E_class = "transformer"
        cfg.model.G_args.G_class = "transformer"
        return cfg
    jm = j_build(small(JC).model, n_vocab=13, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(2))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(small(TC).model, n_vocab=13, max_seq_len=10)
    return jm, jp, tm, t_ck.params_from_jax(flat), setup[4], setup[5]


@pytest.mark.parametrize("capacity", [None, 20])
def test_transformer_round_matches_jax(tfm_setup, capacity):
    """The fused round of the transformer family under the JAX round's
    draws: the same accept set and the same tokens, in both decode modes
    (the JAX round decodes with its XLA arm, the port with the plain
    version of its kernel)."""
    jm, jp, tm, tp, q, heads = tfm_setup
    key = jax.random.PRNGKey(23)
    jq = j_gmm.GMMParams(*map(jnp.asarray, q))
    want = j_fused._fused_round(
        jm, jp, key, "gmm_diag", jq, *map(jnp.asarray, heads), N,
        beam_size=5, decode_dtype="float32", capacity=capacity,
        beam_chunk=None)
    want = [np.asarray(a) for a in want]
    tq = t_gmm.GMMParams(*map(torch.from_numpy, q))
    got = t_fused._round_body(
        tm, shards_of(tp), _jax_draws(key, q, N), "gmm_diag", tq,
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32",
        capacity=capacity)
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[4], want[4])        # accept
    np.testing.assert_array_equal(got[5], want[5])        # tokens
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6)
    assert 0 < want[4].sum() < N
    if capacity is not None:
        np.testing.assert_array_equal(got[6], want[6])
        np.testing.assert_array_equal(got[7], want[7])
