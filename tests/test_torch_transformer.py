"""The port's transformer family against the JAX package's
``models/transformer.py`` on the CPU, on the same parameters (carried over
by ``params_from_jax``) and numpy-seeded inputs, at a small size (V 13,
max_seq_len 10, z 12, emb 10, d_model 128, 2 layers, d_ff 256, 4 heads).

Tolerance atol/rtol 1e-5 in f32 (the two frameworks sum in different
orders); the bf16 case 3e-2 on logits of order 1 (bf16 keeps about three
significant digits and the two round products at different points).
The GELU and LayerNorm cases fail if either helper falls back to torch's
defaults (erf GELU, eps 1e-5), which move values by about 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.models import transformer as j_tfm
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.models import transformer as t_tfm
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import nn as t_nn
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

B, V, T = 7, 13, 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _small(C, bf16=False):
    cfg = C.default_config()
    cfg.model.E_args.E_class = "transformer"
    cfg.model.G_args.G_class = "transformer"
    cfg.model.z_dim, cfg.model.emb_dim = 12, 10
    cfg.model.G_args.T_args.bf16 = bf16
    return cfg


def _models(bf16=False):
    jm = j_build(_small(JC, bf16).model, n_vocab=V, max_seq_len=T)
    jp = jm.init_params(jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(_small(TC, bf16).model, n_vocab=V, max_seq_len=T)
    return jm, jp, tm, t_ck.params_from_jax(flat)


@pytest.fixture(scope="module")
def models():
    return _models()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, 12)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    toks = rng.integers(4, V, (B, T)).astype(np.int32)
    toks[:3, 6:] = 1                                      # PAD tails
    return z, c, toks


def _steps(model, params, z, c, toks, n, to_np):
    """Logits of n free-running steps from init_cache on toks[:, :n]."""
    h = model.init_decoder_hidden(params, z, c)
    out = []
    for t in range(n):
        tok = toks[:, t]
        logits, h = model.decode_step(params, tok, None, z, c, h)
        out.append(to_np(logits))
    return out, h


def test_init_cache_matches_jax(models):
    jm, jp, tm, tp = models
    z, c, _ = _inputs(0)
    want = jm.init_decoder_hidden(jp, jnp.asarray(z), jnp.asarray(c))
    got = tm.init_decoder_hidden(tp, torch.from_numpy(z), torch.from_numpy(c))
    assert len(got["k"]) == 2
    for kv in ("k", "v"):
        for w, g in zip(want[kv], got[kv]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def test_apply_step_logits_match_jax(models):
    jm, jp, tm, tp = models
    z, c, toks = _inputs(1)
    want, jh = _steps(jm, jp, jnp.asarray(z), jnp.asarray(c),
                      jnp.asarray(toks), 4, np.asarray)
    got, th = _steps(tm, tp, torch.from_numpy(z), torch.from_numpy(c),
                     torch.from_numpy(toks), 4, lambda a: a.numpy())
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, **TOL)
    for w, g in zip(jh["k"], th["k"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_teacher_forced_logits_match_jax(models):
    jm, jp, tm, tp = models
    z, c, toks = _inputs(2)
    want = jm.decode_train(jp, jax.random.PRNGKey(0), jnp.asarray(toks),
                           jnp.asarray(z), jnp.asarray(c), train=False)
    got = tm.decode_train(tp, torch.from_numpy(toks), torch.from_numpy(z),
                          torch.from_numpy(c), train=False)
    assert got.shape == (B, T, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_teacher_forced_with_word_dropout_masks(models):
    """train=True with the JAX draw of the word-dropout mask injected."""
    jm, jp, tm, tp = models
    z, c, toks = _inputs(5)
    key = jax.random.PRNGKey(9)
    want = jm.decode_train(jp, key, jnp.asarray(toks), jnp.asarray(z),
                           jnp.asarray(c), train=True)
    k_wd, _ = jax.random.split(key)
    drop = np.array(jax.random.bernoulli(k_wd, 0.3, toks.shape))
    got = tm.decode_train(tp, torch.from_numpy(toks), torch.from_numpy(z),
                          torch.from_numpy(c), train=True,
                          word_drop=torch.from_numpy(drop))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_matches_jax(models):
    jm, jp, tm, tp = models
    _, _, toks = _inputs(3)
    mu_w, lv_w = jm.encode(jp, jnp.asarray(toks))
    mu, lv = tm.encode(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_w), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_w), **TOL)


def test_bf16_step_matches_jax():
    """T_args.bf16 on with f32 weights: both sides compute the blocks in
    bfloat16 (looser tolerance, see the module docstring)."""
    jm, jp, tm, tp = _models(bf16=True)
    z, c, toks = _inputs(4)
    want, _ = _steps(jm, jp, jnp.asarray(z), jnp.asarray(c),
                     jnp.asarray(toks), 3, np.asarray)
    got, th = _steps(tm, tp, torch.from_numpy(z), torch.from_numpy(c),
                     torch.from_numpy(toks), 3, lambda a: a.numpy())
    assert th["k"][0].dtype == torch.bfloat16
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 801).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = t_nn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4      # torch's default differs


def test_layer_norm_eps_inside_the_rsqrt():
    rng = np.random.default_rng(6)
    x = (1e-3 * rng.standard_normal((5, 128))).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(j_tfm._ln({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                                jnp.asarray(x)))
    got = t_nn.layer_norm({"g": torch.from_numpy(g),
                           "b": torch.from_numpy(b)},
                          torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (128,), torch.from_numpy(g),
        torch.from_numpy(b)).numpy()
    assert np.abs(default - want).max() > 1e-3  # eps 1e-5 differs


def test_seeded_init_has_the_checkpoint_layout(models):
    """The port's own seeded init has the JAX tree's paths and shapes, the
    blocks a list."""
    _, jp, tm, _ = models
    want = {k: np.asarray(v).shape
            for k, v in j_ck._flatten({"params": jp}).items()
            if not k.startswith("['params']['clf']")}
    got = t_ck.flatten(tm.init_params(torch.Generator().manual_seed(0)))
    assert {t_ck.keystr(("params",) + p): tuple(v.shape)
            for p, v in got.items()} == want
    assert isinstance(t_tfm.init_decoder(torch.Generator(), 10, 12, 2, V, T)
                      ["blocks"], list)
