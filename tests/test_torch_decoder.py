"""GRU cell and decoder step of the port against the JAX package
(rtol = atol = 1e-5: fp32 products summed in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.models import decoder as j_dec
from controlled_peptide_generation_tpu.ops import gru as j_gru
from controlled_peptide_generation_tpu.ops import nn as j_nn

from controlled_peptide_generation_tpu_torch.models import decoder as t_dec
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(seed, V=13, E=10, zc=14):
    k = jax.random.split(jax.random.PRNGKey(seed), 2)
    dec = j_dec.init(k[0], emb_dim=E + zc, output_dim=V, h_dim=zc)
    emb = j_nn.init_embedding(k[1], V, E)
    to_t = lambda tree: jax.tree.map(lambda a: torch.from_numpy(
        np.array(a)), tree)
    return dec, emb, to_t(dec), to_t(emb)


@pytest.mark.parametrize("seed", [0, 1])
def test_gru_cell_pregated(seed):
    dec, _, tdec, _ = _params(seed)
    rng = np.random.default_rng(seed)
    gi = rng.standard_normal((9, 42)).astype(np.float32)
    h = rng.standard_normal((9, 14)).astype(np.float32)
    want = j_gru.gru_cell_pregated(dec["gru"], jnp.asarray(gi),
                                   jnp.asarray(h))
    got = t_gru.gru_cell_pregated(tdec["gru"], torch.from_numpy(gi),
                                  torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_step(seed):
    dec, emb, tdec, temb = _params(seed)
    rng = np.random.default_rng(10 + seed)
    B = 11
    z = rng.standard_normal((B, 12)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    tok = rng.integers(0, 13, B).astype(np.int32)
    tok[:3] = 1                                   # PAD embeds to zero
    h = np.asarray(j_dec.init_hidden(jnp.asarray(z), jnp.asarray(c)))
    h = h + 0.1 * rng.standard_normal(h.shape).astype(np.float32)
    lw, hw = j_dec.apply_step(dec, emb, jnp.asarray(tok), None,
                              jnp.asarray(z), jnp.asarray(c),
                              jnp.asarray(h))
    T = torch.from_numpy
    lt, ht = t_dec.apply_step(tdec, temb, T(tok), None, T(z), T(c), T(h))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lw), **TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hw), **TOL)
    np.testing.assert_array_equal(
        t_dec.init_hidden(T(z), T(c)).numpy(),
        np.asarray(j_dec.init_hidden(jnp.asarray(z), jnp.asarray(c))))
