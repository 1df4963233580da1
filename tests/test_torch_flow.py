"""The flows on z in the port against the JAX package on the CPU, at a
small size (V 13, z 6, emb 10, encoder h 5, T 7): ``flow.apply`` and its
gradients for planar, radial and alternating flows with each
invertibility constraint inactive and active (planar margin < -1, radial
beta < -alpha); ``kl_flow_mc``; the flow-posterior phase-1 loss and its
gradients with the JAX draws injected; the heldout flow arm; where each
flow_mode applies the flow in generation and in ``decode_from_z``; the
fused CLaSS round against the JAX round's; a tiny CLI run and the flat
Adam's state loading into the JAX package.

Tolerances: losses, metrics and the flow's outputs rtol 1e-5 (atol 1e-6
on the outputs); gradients within 1e-4 of each tensor's largest entry;
tokens equal."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.api import load_vocab as j_load_vocab
from controlled_peptide_generation_tpu.generation import (
    generate_sentences as j_generate)
from controlled_peptide_generation_tpu.latent import fused as j_fused
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.models import flow as j_flow
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train.train_vae import (
    _heldout_fn as j_heldout_fn)

from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch.api import load_vocab
from controlled_peptide_generation_tpu_torch.generation import (
    generate_sentences)
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.models import flow as t_flow
from controlled_peptide_generation_tpu_torch.ops import losses as t_L
from controlled_peptide_generation_tpu_torch.parallel.rounds import shards_of
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv

from test_torch_fused import N, _jax_draws as jax_round_draws
from test_torch_serial import VOCAB
from test_torch_skip import (  # noqa: F401 (one_thread: a fixture)
    B, LOSS_TOL, TOL, assert_grad, check_flat_state, check_loss_fn, latents,
    models, one_thread, t_, tiny_cli, to_port, tokens)

POSTERIOR = ["--model.flow", "3", "--model.flow_type", "alternating",
             "--model.flow_mode", "posterior"]
GEN_PRIOR = ["--model.flow", "3", "--model.flow_type", "alternating"]


def _flow_params(flow_type, active, seed=0, z_dim=6):
    """Three layers' parameters; with ``active`` every layer's constraint
    binds (planar: scale.w < -1; radial: beta < -alpha)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    p = {}
    if flow_type in ("planar", "alternating"):
        w = f(3, z_dim)
        scale = (-2.0 * w if active else 0.1 * f(3, z_dim)).astype(
            np.float32)
        p["planar"] = {"w": w, "b": 0.3 * f(3), "scale": scale}
        margins = (scale * w).sum(1)
        assert (margins < -1).all() == active and (
            (margins < -1).any() == active)
    if flow_type in ("radial", "alternating"):
        alpha = (0.5 + rng.random(3)).astype(np.float32)
        beta = (-alpha - 1.0 if active else 0.3 * f(3)).astype(np.float32)
        if not active:
            beta = np.abs(beta)
        p["radial"] = {"z0": 0.5 * f(3, z_dim), "alpha": alpha,
                       "beta": beta}
    return p


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("flow_type", ["planar", "radial", "alternating"])
def test_flow_apply_and_grads_match_jax(flow_type, active):
    params = _flow_params(flow_type, active)
    z = np.random.default_rng(1).standard_normal((5, 6)).astype(np.float32)
    wz = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    wl = np.random.default_rng(3).standard_normal(5).astype(np.float32)

    def scalar(p, z_):
        zk, ld = j_flow.apply(p, flow_type, z_)
        return jnp.sum(zk * wz) + jnp.sum(ld * wl), (zk, ld)

    (jg, jgz), (jzk, jld) = jax.grad(scalar, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z))
    tp = jax.tree.map(lambda a: t_(a).requires_grad_(True), params)
    tz = t_(z).requires_grad_(True)
    zk, ld = t_flow.apply(tp, flow_type, tz)
    np.testing.assert_allclose(zk.detach().numpy(), np.asarray(jzk), **TOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), **TOL)
    leaves = jax.tree.leaves(tp) + [tz]
    grads = torch.autograd.grad((zk * t_(wz)).sum() + (ld * t_(wl)).sum(),
                                leaves)
    for g, want in zip(grads, jax.tree.leaves(jg) + [jgz]):
        assert_grad(g, want, flow_type)


def test_flow_init_layout_and_kl_flow_mc():
    """init's tree is the JAX package's; kl_flow_mc equals JAX's."""
    jp = j_flow.init(jax.random.PRNGKey(0), "alternating", 3, 6)
    tp = t_flow.init(torch.Generator().manual_seed(0), "alternating", 3, 6)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa
    assert shapes(tp) == shapes(jp)
    assert 0.01 <= float(tp["radial"]["alpha"].min())
    assert float(tp["planar"]["w"].abs().max()) <= 0.01
    with pytest.raises(ValueError, match="planar, radial, or alternating"):
        t_flow.init(None, "affine", 3, 6)
    rng = np.random.default_rng(4)
    mu, lv, z0, zk = (rng.standard_normal((5, 6)).astype(np.float32)
                      for _ in range(4))
    ld = rng.standard_normal(5).astype(np.float32)
    want = j_L.kl_flow_mc(*map(jnp.asarray, (mu, lv, z0, zk, ld)))
    got = t_L.kl_flow_mc(*map(t_, (mu, lv, z0, zk, ld)))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


@pytest.mark.parametrize("z_regu", ["mmdrf", "kl"])
def test_flow_posterior_loss_fn_matches_jax(z_regu, one_thread):
    grads = check_loss_fn(POSTERIOR, 7, z_regu)
    assert float(grads["flow"]["radial"]["beta"].abs().sum()) > 0


def test_flow_heldout_arm_matches_jax(one_thread):
    """The heldout batch of a posterior flow (recon, the flow KL, mu,
    logvar) against the JAX package's heldout fn at its draws."""
    _, _, jm, tm = models(POSTERIOR, 7)
    jp = jm.init_params(jax.random.PRNGKey(11))
    key = jax.random.PRNGKey(12)
    text = tokens(13, 7)
    want = j_heldout_fn(jm)(jp, key[None], jnp.asarray(text)[None])
    kz, kc, _ = jax.random.split(key, 3)
    draws = {"eps": t_(jax.random.normal(kz, (B, 6))),
             "c_bits": t_(jax.random.bernoulli(kc, 0.5, (B,)))}
    got = t_tv.heldout_batch(tm, to_port(jp), t_(text), draws=draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[0], **TOL)


@pytest.mark.parametrize("argv", [GEN_PRIOR, POSTERIOR],
                         ids=["gen_prior", "posterior"])
def test_flow_modes_in_generation_and_decode_from_z(argv, one_thread):
    """generate_sentences (greedy and beam) maps z by a gen_prior flow and
    not by a posterior one, as the JAX package's; decode_from_z (n 37 in
    chunks of 16, each chunk's c injected from the JAX keys) maps it
    before the chunks for a posterior flow: the peptides equal."""
    _, _, jm, tm = models(argv, 10)
    # a flow far from the identity (init's is within 1e-2 of it)
    strong = jax.tree.map(jnp.asarray, _flow_params("alternating", False))
    jp = dict(jm.init_params(jax.random.PRNGKey(14)), flow=strong)
    tp = to_port(jp)
    z, c = latents(15, 9)
    for mode in ("greedy", "beam"):
        want, wz, _ = j_generate(jm, jp, jax.random.PRNGKey(0), 9,
                                 z=jnp.asarray(z), c=jnp.asarray(c),
                                 sample_mode=mode)
        got, gz, _ = generate_sentences(tm, tp, 9, z=t_(z), c=t_(c),
                                        sample_mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(gz.numpy(), np.asarray(wz), **TOL)
    flowed = not np.allclose(gz.numpy(), z)
    assert flowed == (tm.flow_mode == "gen_prior")
    n, chunk = 37, 16
    zq = np.random.default_rng(16).standard_normal((n, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(17)
    _, _, jm24, tm24 = models(argv, 10, n_vocab=24)
    jp24 = dict(jm24.init_params(jax.random.PRNGKey(18)), flow=strong)
    want = j_pipeline.decode_from_z(
        zq, jm24, jp24, types.SimpleNamespace(
            idx2sentences=j_load_vocab(VOCAB).to_sentences_batch), key=key,
        chunk=chunk)
    cs = [t_(jm24.sample_c_prior(
        jax.random.split(jax.random.fold_in(key, s), 3)[1], chunk))
        for s in range(0, n, chunk)]
    got = pipeline.decode_from_z(zq, tm24, shards_of(to_port(jp24)),
                                 load_vocab(VOCAB), chunk=chunk, cs=cs)
    assert got == list(want) and len(set(got)) > 1
    # the flow moves the decodes: without it they differ
    unflowed = pipeline.decode_from_z(
        zq, tm24, shards_of(dict(to_port(jp24), flow=to_port(
            {"flow": jax.tree.map(lambda a: 0 * a, strong)})["flow"])),
        load_vocab(VOCAB), chunk=chunk, cs=cs)
    assert unflowed != got


@pytest.mark.parametrize("capacity", [None, 20])
def test_flow_fused_round_matches_jax(capacity, one_thread):
    """The round under the JAX round's draws (a posterior flow at z 12):
    the same accept set and tokens; z is the raw draw, not flow(z)."""
    argv = POSTERIOR + ["--model.z_dim", "12", "--model.E_args.h_dim", "8"]
    _, _, jm, tm = models(argv, 10)
    jp = dict(jm.init_params(jax.random.PRNGKey(19)), flow=jax.tree.map(
        jnp.asarray, _flow_params("alternating", False, z_dim=12)))
    tp = to_port(jp)
    rng = np.random.default_rng(4)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, 12)).astype(np.float32),
         (0.5 + rng.random((4, 12))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, 12))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    key = jax.random.PRNGKey(23)
    want = [np.asarray(a) for a in j_fused._fused_round(
        jm, jp, key, "gmm_diag", j_gmm.GMMParams(*map(jnp.asarray, q)),
        *map(jnp.asarray, heads), N, beam_size=5, decode_dtype="float32",
        capacity=capacity)]
    draws = jax_round_draws(key, q, N)
    got = [a.numpy() for a in t_fused._round_body(
        tm, shards_of(tp), draws, "gmm_diag",
        t_gmm.GMMParams(*map(torch.from_numpy, q)),
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32",
        capacity=capacity)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[4], want[4])        # accept
    np.testing.assert_array_equal(got[5], want[5])        # tokens
    assert 0 < want[4].sum() < N
    if capacity is not None:
        np.testing.assert_array_equal(got[6], want[6])
        np.testing.assert_array_equal(got[7], want[7])
    flowed = tm.apply_flow(tp, t_(got[0]))[0].numpy()
    assert np.abs(flowed - got[0]).max() > 1e-1
    # the decode reads flow(z): without the flow other tokens come out
    plain_z = t_fused._round_body(
        tm, shards_of(dict(tp, flow=jax.tree.map(lambda a: 0 * a,
                                                 tp["flow"]))), draws,
        "gmm_diag", t_gmm.GMMParams(*map(torch.from_numpy, q)),
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32",
        capacity=capacity)[5].numpy()
    assert not np.array_equal(plain_z, got[5])


def test_flow_tiny_cli_run_and_flat_state(tmp_path, one_thread):
    _, keys = tiny_cli(POSTERIOR, tmp_path, "flow")
    assert {"['params']['flow']['planar']['scale']",
            "['opt'][1][0].nu['flow']['radial']['z0']"} <= keys
    check_flat_state(POSTERIOR, 7, tmp_path)
