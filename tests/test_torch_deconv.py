"""The deconv decoder family in the port against the JAX package on the
CPU, at a small size (V 13, z 6, emb 10, 8 filters, kernel 4, 3 deconv
layers, T 25: spatial 1 -> 4 -> 11 -> 25): ``deconv.apply`` and the
gradients of its logits in the default branch and the ``useRNN``,
no-batch-norm and no-final-conv branches; make_loss_fn's loss and
gradients with the JAX draws injected; ``beam_search_logits`` and
``sample_from_logits`` (hard and soft modes, the Gumbel noise injected);
generation; the fused CLaSS round (the batch-norm rows of every chunk and
of the accepted-first capacity as in the JAX round); ``decode_top1`` with
a zero-padded last chunk and the JAX package's c; the GRU scan beyond the
CUDA kernels' H scope (the plain route and its counter); a tiny CLI run
and the flat Adam's state loading into the JAX package.

Tolerances: logits rtol 1e-5 / atol 1e-5 (batch norm divides by the
batch's deviation; fp32 sums in other orders); losses and metrics rtol
1e-5; gradients within 1e-4 of each tensor's largest entry. With batch
norm, the exact gradient of every bias ahead of a batch norm is 0, and so
is that of bn_out's scale ahead of relu, the final conv and its batch
norm (scale invariance while bn_out's bias is 0, as at init): there both
packages give the rounding noise of a sum over every position (up to
4.4e-5 of the tree's largest gradient at these widths), each held within
ZERO_REL of it; beam tokens equal, scores
within 1e-5; sampled tokens equal, soft rows rtol 1e-5 / atol 1e-6."""

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
from controlled_peptide_generation_tpu.ops import beam as j_beam
from controlled_peptide_generation_tpu.ops import gru as j_gru
from controlled_peptide_generation_tpu.ops import sampling as j_samp
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch.api import load_vocab
from controlled_peptide_generation_tpu_torch.generation import (
    generate_sentences)
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.ops import beam as t_beam
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru
from controlled_peptide_generation_tpu_torch.ops import sampling as t_samp
from controlled_peptide_generation_tpu_torch.parallel.rounds import shards_of
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

from test_torch_fused import N, _jax_draws as jax_round_draws
from test_torch_serial import VOCAB
from test_torch_skip import (  # noqa: F401 (one_thread: a fixture)
    TOL, V, assert_grads, check_flat_state, check_loss_fn, latents, models,
    one_thread, t_, tiny_cli, to_port)

T = 25
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
ZERO_REL = 2e-4
DECONV = ["--model.G_args.G_class", "deconv"]
BRANCHES = {
    "default": [],
    "useRNN": ["--model.G_args.deconv_args.useRNN", "1"],
    "no_batch_norm": ["--model.G_args.deconv_args.use_batch_norm", "0",
                      "--model.G_args.deconv_args.temperature", "0.7"],
    "no_final_conv": ["--model.G_args.deconv_args.add_final_conv_layer",
                      "0"],
}


def zero_grads(branch):
    """The leaves of a branch whose exact gradient is 0 (above)."""
    if branch == "no_batch_norm":
        return set()
    convs = ["deconv0", "deconv1", "conv0", "conv1", "deconv_out"]
    if branch != "no_final_conv":
        convs.append("final_conv")
    return ({f"['{n}']['b']" for n in convs}
            | ({"['bn_out']['scale']"} if branch != "no_final_conv"
               else set()))


@pytest.fixture(scope="module")
def deconv():
    """The default branch's models and the JAX params in both trees, EOS's
    logit lowered by 3 (at init nearly every decode ends at once, which
    would hide which rows batch norm reads)."""
    _, _, jm, tm = models(DECONV, T)
    jp = jm.init_params(jax.random.PRNGKey(0))
    fc = jp["dec"]["fc"]
    jp["dec"]["fc"] = dict(fc, b=fc["b"].at[3].add(-3.0))
    return jm, jp, tm, to_port(jp)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_deconv_apply_and_grads_match_jax(branch, one_thread):
    """The logits [B, 25, V] of 9 latents, and the gradient of a weighted
    sum of them with respect to every decoder leaf."""
    _, _, jm, tm = models(DECONV + BRANCHES[branch], T)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = to_port(jp)
    assert ("rnn" in tp["dec"]) == (branch == "useRNN")
    assert ("final_conv" in tp["dec"]) == (branch != "no_final_conv")
    z, c = latents(2, 9)
    w = np.random.default_rng(3).standard_normal((9, T, V)).astype(
        np.float32)

    def scalar(dec):
        logits = jm.decode_logits(dict(jp, dec=dec), jnp.asarray(z),
                                  jnp.asarray(c))
        return jnp.sum(logits * w), logits

    jg, want = jax.jit(jax.grad(scalar, has_aux=True))(jp["dec"])
    dec = t_ck.flatten(tp["dec"])
    for leaf in dec.values():
        leaf.requires_grad_(True)
    got = tm.decode_logits(tp, t_(z), t_(c))
    assert got.shape == (9, T, V)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    grads = torch.autograd.grad((got * t_(w)).sum(), list(dec.values()),
                                allow_unused=True)
    # without batch norm its parameters are unused: JAX's gradient is 0
    assert_grads({p: torch.zeros_like(leaf) if g is None else g
                  for (p, leaf), g in zip(dec.items(), grads)},
                 j_ck._flatten(jg), zero_grads(branch), ZERO_REL)


def test_deconv_loss_fn_matches_jax(one_thread):
    grads = check_loss_fn(DECONV, T, zero=zero_grads("default"),
                          zero_rel=ZERO_REL)
    assert float(grads["dec"]["deconv0"]["w"].abs().sum()) > 0


@pytest.mark.parametrize("K,n_best,min_length", [(5, 1, 1), (5, 3, 4),
                                                 (12, 2, 1)])
def test_beam_search_logits_matches_jax(K, n_best, min_length):
    """64 sentences over spread logits: every hypothesis's tokens equal,
    scores within 1e-5; the replay counts in its own counter."""
    logits = 2.5 * np.random.default_rng(K + n_best).standard_normal(
        (64, T, V)).astype(np.float32)
    want_h, want_s = j_beam.beam_search_logits(
        jnp.asarray(logits), beam_size=K, n_best=n_best,
        min_length=min_length)
    runs, plain = t_beam.beam_search_logits.runs, t_beam.beam_search.plain_runs
    got_h, got_s = t_beam.beam_search_logits(t_(logits), beam_size=K,
                                             n_best=n_best,
                                             min_length=min_length)
    assert t_beam.beam_search_logits.runs == runs + 1
    assert t_beam.beam_search.plain_runs == plain
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("mode,prevent_empty", [
    ("greedy", True), ("categorical", True), ("categorical", False),
    ("none_softmax", False), ("greedy_softmax", False),
    ("categorical_softmax", False)])
def test_sample_from_logits_matches_jax(mode, prevent_empty):
    """Tokens equal; soft rows and their gradient with respect to the
    logits (of a weighted sum) within TOL."""
    rng = np.random.default_rng(4)
    logits = 2.0 * rng.standard_normal((6, T, V)).astype(np.float32)
    w = rng.standard_normal((6, T + 1, V)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = t_(np.stack([np.array(jax.random.gumbel(k, (6, V)))
                         for k in jax.random.split(key, T)]))
    kw = dict(sample_mode=mode, temp=0.8, prevent_empty=prevent_empty)
    if mode not in t_samp.SOFT_MODES:
        want = j_samp.sample_from_logits(key, jnp.asarray(logits), **kw)
        got = t_samp.sample_from_logits(t_(logits), noise=noise, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got == 3).any()
        return

    def scalar(lg):
        tok, soft = j_samp.sample_from_logits(key, lg, **kw)
        return jnp.sum(soft * w), (tok, soft)

    jg, (jtok, jsoft) = jax.grad(scalar, has_aux=True)(jnp.asarray(logits))
    tl = t_(logits).requires_grad_(True)
    tok, soft = t_samp.sample_from_logits(tl, noise=noise, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(jsoft),
                               **TOL)
    (g,) = torch.autograd.grad((soft * t_(w)).sum(), [tl])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)


def test_deconv_generation_matches_jax(deconv):
    """generate_sentences, greedy and beam (n_best 3), replays the logits
    as the JAX package's; the step sampler of phase 2 refuses the
    family, as the JAX package's cannot step it."""
    jm, jp, tm, tp = deconv
    z, c = latents(6, 9)
    for mode in ("greedy", "beam"):
        want, _, _ = j_generate(jm, jp, jax.random.PRNGKey(0), 9,
                                z=jnp.asarray(z), c=jnp.asarray(c),
                                sample_mode=mode)
        got, _, _ = generate_sentences(tm, tp, 9, z=t_(z), c=t_(c),
                                       sample_mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="no free-running step"):
        t_samp.sample_sentences(tm, tp, t_(z), t_(c),
                                sample_mode="greedy_softmax")


@pytest.mark.parametrize("capacity,beam_chunk",
                         [(None, None), (20, None), (None, 24)])
def test_deconv_fused_round_matches_jax(deconv, capacity, beam_chunk):
    """The round under the JAX round's draws: the accept set, the
    compaction and the tokens equal (batch norm over the same rows: the
    chunks of 24 of 64, the 20 slots with their invalid ones)."""
    jm, jp, tm, tp = deconv
    rng = np.random.default_rng(4)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, 6)).astype(np.float32),
         (0.5 + rng.random((4, 6))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, 6))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    key = jax.random.PRNGKey(17)
    want = [np.asarray(a) for a in j_fused._fused_round(
        jm, jp, key, "gmm_diag", j_gmm.GMMParams(*map(jnp.asarray, q)),
        *map(jnp.asarray, heads), N, beam_size=5, decode_dtype="float32",
        capacity=capacity, beam_chunk=beam_chunk)]
    runs = t_beam.beam_search_logits.runs
    got = [a.numpy() for a in t_fused._round_body(
        tm, shards_of(tp), jax_round_draws(key, q, N), "gmm_diag",
        t_gmm.GMMParams(*map(torch.from_numpy, q)),
        *map(torch.from_numpy, heads), beam_size=5, decode_dtype="float32",
        capacity=capacity, beam_chunk=beam_chunk)]
    assert t_beam.beam_search_logits.runs == runs + (
        3 if beam_chunk else 1)
    np.testing.assert_array_equal(got[4], want[4])        # accept
    np.testing.assert_array_equal(got[5], want[5])        # tokens
    assert 0 < want[4].sum() < N
    assert len({tuple(r) for r in got[5].tolist()}) > 1
    if capacity is not None:
        np.testing.assert_array_equal(got[6], want[6])
        np.testing.assert_array_equal(got[7], want[7])
        assert not want[7].all()          # invalid slots in the batch


def test_deconv_decode_top1_matches_jax(one_thread):
    """n 37 in chunks of 16, the last padded from 5 rows (the pad rows
    enter batch norm), each chunk's c from the JAX keys: the peptides of
    JAX decode_from_z."""
    _, _, jm, tm = models(DECONV, T, n_vocab=24)
    jp = jm.init_params(jax.random.PRNGKey(7))
    n, chunk = 37, 16
    z = np.random.default_rng(8).standard_normal((n, 6)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = j_pipeline.decode_from_z(
        z, jm, jp, types.SimpleNamespace(
            idx2sentences=j_load_vocab(VOCAB).to_sentences_batch), key=key,
        chunk=chunk)
    cs = [t_(jm.sample_c_prior(
        jax.random.split(jax.random.fold_in(key, s), 3)[1], chunk))
        for s in range(0, n, chunk)]
    got = pipeline.decode_from_z(z, tm, shards_of(to_port(jp)),
                                 load_vocab(VOCAB), chunk=chunk, cs=cs)
    assert got == list(want) and len(set(got)) > 1


def test_gru_scan_beyond_the_kernels_scope(one_thread):
    """H 129 (the deconv useRNN GRU's H = emb_dim beyond the CUDA kernels'
    H <= 128): the plain recurrence, counted, equal to the JAX scan, with
    and without autograd; H 128 is not counted."""
    rng = np.random.default_rng(10)
    for H, counted in ((129, 1), (128, 0)):
        p = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in (("wi", (7, 3 * H)), ("wh", (H, 3 * H)),
                          ("bi", (3 * H,)), ("bh", (3 * H,)))}
        xs = rng.standard_normal((3, 5, 7)).astype(np.float32)
        h0 = rng.standard_normal((3, H)).astype(np.float32)
        want, _ = j_gru.gru_scan(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(xs), jnp.asarray(h0))
        runs = t_gru.gru_scan.plain_runs
        with torch.no_grad():
            got, _ = t_gru.gru_scan(jax.tree.map(t_, p), t_(xs), t_(h0))
        tp = jax.tree.map(lambda a: t_(a).requires_grad_(True), p)
        got_g, _ = t_gru.gru_scan(tp, t_(xs), t_(h0))
        assert t_gru.gru_scan.plain_runs == runs + 2 * counted
        for g in (got, got_g):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                       **TOL)


def test_deconv_tiny_cli_run_and_flat_state(tmp_path, one_thread):
    _, keys = tiny_cli(DECONV, tmp_path, "deconv")
    assert {"['params']['dec']['deconv_out']['w']",
            "['opt'][1][0].nu['dec']['conv1']['b']"} <= keys
    check_flat_state(DECONV + BRANCHES["useRNN"], T, tmp_path)
