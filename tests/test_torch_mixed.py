"""The mixed families (a transformer encoder with a GRU decoder, and a GRU
encoder with a transformer decoder) of the port against the JAX package
on the CPU, at a small width (V 13, z 6, emb 10, encoder h 5, d_model 16,
one layer, d_ff 32, 2 heads, the blocks' dropout on): the phase-1 loss,
metrics and every gradient at the same params, batch and draws (T 7, B
4, the JAX draws recreated from its key splits and injected), and a
fused CLaSS round under the JAX round's draws (T 10, 64 candidates):
the same accept set and tokens (tests/test_torch_fused.py's gates).

Tolerances: loss and metrics rtol 1e-5; gradients rtol 1e-4 / atol 1e-5,
as tests/test_torch_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.latent import fused as j_fused
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train.train_vae import (
    make_loss_fn as j_make_loss_fn)

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.parallel.rounds import shards_of
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv

from test_torch_fused import N, _jax_draws as _jax_round_draws
from test_torch_phase2 import (B, TLEN, _decoder_draws, _encoder_draws, _t,
                               _to_port, _tokens, _tree)

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
FAMILIES = [("transformer", "gru"), ("gru", "transformer")]


def _flags(families, max_seq_len=TLEN):
    out = ["--model.E_args.E_class", families[0],
           "--model.G_args.G_class", families[1],
           "--model.z_dim", "6", "--model.emb_dim", "10",
           "--model.E_args.h_dim", "5", "--max_seq_len", str(max_seq_len),
           "--losses.wae_mmd.rf_dim", "16", "--phase", "1"]
    for part in ("E_args", "G_args"):
        for k, v in (("d_model", 16), ("d_ff", 32), ("n_heads", 2),
                     ("n_layers", 1), ("p_dropout", 0.1)):
            out += [f"--model.{part}.T_args.{k}", str(v)]
    return out


def _models(families, max_seq_len=TLEN, n_vocab=13):
    jcfg, _, _ = JC.parse_and_finalize(_flags(families, max_seq_len))
    tcfg, _, _ = TC.parse_and_finalize(_flags(families, max_seq_len))
    return (jcfg, tcfg,
            j_build(jcfg.model, n_vocab=n_vocab, max_seq_len=max_seq_len),
            t_build(tcfg.model, n_vocab=n_vocab, max_seq_len=max_seq_len))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("families", FAMILIES)
def test_mixed_loss_fn_matches_jax(families, one_thread):
    jcfg, tcfg, jm, tm = _models(families)
    jparams = jm.init_params(jax.random.PRNGKey(50))
    jparams = {k: v for k, v in jparams.items() if k != "clf"}
    rf = j_L.init_rf_basis(jax.random.PRNGKey(51), 6, 16)
    key = jax.random.PRNGKey(52)
    text = _tokens(53)
    j_loss = j_make_loss_fn(jm, jcfg.vae, jcfg.losses.wae_mmd, rf)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jparams, key, jnp.asarray(text), 1.25)

    k_fwd, k_mmd, k_rf, _ = jax.random.split(key, 4)
    kz, kc, kd, ke = jax.random.split(k_fwd, 4)
    draws = _tree({"eps": jax.random.normal(kz, (B, 6)),
                   "c_bits": jax.random.bernoulli(kc, 0.5, (B,)),
                   "z_prior_mmd": jax.random.normal(k_mmd, (B, 6)),
                   "z_prior_rf": jax.random.normal(k_rf, (B, 6)),
                   **_decoder_draws(jm, kd, B), **_encoder_draws(jm, ke, B)})
    assert set(draws) == set(t_tv.draw_step(
        tm, torch.Generator().manual_seed(0), B, TLEN, "cpu"))
    tparams = _to_port(jparams)
    t_loss = t_tv.make_loss_fn(tm, tcfg.vae, tcfg.losses.wae_mmd,
                               tuple(_t(a) for a in rf))
    tl, tmet, tg = t_tv.loss_and_grads(t_loss, tparams, _t(text), 1.25,
                                       draws)
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    jflat = j_ck._flatten(jg)
    tflat = t_ck.flatten(tg)
    assert {t_ck.keystr(p) for p in tflat} == set(jflat)
    for p, g in tflat.items():
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jflat[t_ck.keystr(p)]),
            err_msg=t_ck.keystr(p), **GRAD_TOL)


@pytest.mark.parametrize("families", FAMILIES)
def test_mixed_round_matches_jax(families):
    """One fused round of 64 under the JAX round's draws: the decoder's
    family picks the beam (B1's plain version for the GRU, B3's for the
    transformer), the encoder takes no part."""
    _, _, jm, tm = _models(families, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(54))
    tp = t_ck.params_from_jax({k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": jp}).items()})
    rng = np.random.default_rng(55)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, 6)).astype(np.float32),
         (0.5 + rng.random((4, 6))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, 6))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    key = jax.random.PRNGKey(56)
    want = j_fused._fused_round(
        jm, jp, key, "gmm_diag", j_gmm.GMMParams(*map(jnp.asarray, q)),
        *map(jnp.asarray, heads), N, beam_size=5, decode_dtype="float32",
        capacity=None, beam_chunk=None)
    want = [np.asarray(a) for a in want]
    got = t_fused._round_body(
        tm, shards_of(tp), _jax_round_draws(key, q, N), "gmm_diag",
        t_gmm.GMMParams(*map(torch.from_numpy, q)),
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32")
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[4], want[4])        # accept
    np.testing.assert_array_equal(got[5], want[5])        # tokens
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-6)
    assert 0 < want[4].sum() < N
