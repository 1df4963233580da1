"""GRU skip connections in the port against the JAX package on the CPU, at
a small size (V 13, z 6, emb 10, encoder h 5; T 7, or T 25 for the beam):
the teacher-forced decoder and its step, make_loss_fn (the loss, its
metrics and every gradient, the skip maps' biases included) with the JAX
draws injected, the beam (outside B1's scope: the plain version with the
skip head) token-equal to the JAX package's XLA beam, phase 2's
attribute sub-loss, a tiny CLI run, and the flat Adam's state loading
into the JAX package's flat update.

The helpers here serve the flow and deconv files too.

Tolerances: losses and metrics rtol 1e-5; module outputs rtol 1e-5 /
atol 1e-6; gradients within 1e-4 of each tensor's largest entry; beam
tokens equal, scores within 1e-5."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.models import decoder as j_dec
from controlled_peptide_generation_tpu.ops import beam as j_beam
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train.opt import flat_adam
from controlled_peptide_generation_tpu.train.train_vae import (
    make_loss_fn as j_make_loss_fn)

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.generation import (
    generate_sentences)
from controlled_peptide_generation_tpu_torch.models import decoder as t_dec
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import beam as t_beam
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import opt as t_opt
from controlled_peptide_generation_tpu_torch.train import train_full as t_full
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv

from test_torch_phase2 import _assert_group_grads, _jax_parts, jax_full_draws
from test_torch_phase2 import _models as p2_models, _to_port as p2_to_port

LOSS_TOL = dict(rtol=1e-5, atol=0)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4
V, B = 13, 4
SMALL = ["--model.z_dim", "6", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "5", "--losses.wae_mmd.rf_dim", "16",
         "--model.G_args.deconv_args.num_filters", "8"]
SKIP = ["--model.G_args.GRU_args.skip_connections", "1"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- helpers of the three option files --------------------------------------

def t_(a):
    return torch.from_numpy(np.array(a))


def models(argv, T, n_vocab=V):
    """(jcfg, tcfg, JAX model, port model) at the small widths, T steps."""
    argv = SMALL + ["--max_seq_len", str(T)] + list(argv)
    jcfg, _, _ = JC.parse_and_finalize(argv)
    tcfg, _, _ = TC.parse_and_finalize(argv)
    return (jcfg, tcfg, j_build(jcfg.model, n_vocab=n_vocab, max_seq_len=T),
            t_build(tcfg.model, n_vocab=n_vocab, max_seq_len=T))


def to_port(jparams, grad=False):
    """JAX params -> the port's tensors (the classifier left out)."""
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jparams.items() if k != "clf"}}).items()}
    tp = t_ck.params_from_jax(flat)
    for leaf in t_ck.flatten(tp).values():
        leaf.requires_grad_(grad)
    return tp


def tokens(seed, T, n=B):
    rng = np.random.default_rng(seed)
    tok = np.full((n, T), 1, np.int32)
    for row in range(n):
        k = int(rng.integers(1, T - 1))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def latents(seed, n, z_dim=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, z_dim)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def assert_grad(got, want, what):
    """Within GRAD_REL of the JAX gradient's largest entry."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max(initial=0.0))
    assert err <= GRAD_REL * scale, (what, err, scale)


def assert_grads(tflat, jflat, zero=(), zero_rel=0.0, prefix=""):
    """Every port gradient ({path: tensor}) against the JAX gradient of its
    keystr; a leaf whose exact gradient is 0 (keystr in ``zero``, without
    ``prefix``) has both packages' rounding noise there instead: each
    within ``zero_rel`` of the tree's largest gradient."""
    top = max(float(np.abs(np.asarray(g)).max()) for g in jflat.values())
    for p, g in tflat.items():
        key = t_ck.keystr(p)
        want = np.asarray(jflat[key])
        if key[len(prefix):] in zero:
            noise = max(float(g.detach().abs().max()),
                        float(np.abs(want).max()))
            assert noise <= zero_rel * top, (key, noise, top)
        else:
            assert_grad(g, want, key)


def jax_draws(jm, key, n, T):
    """The draws of the JAX loss_fn (train_vae.py: its forward, or its flow
    arm, split the same way) for this key, as the port's draws dict."""
    k_fwd, k_mmd, k_rf, _ = jax.random.split(key, 4)
    kz, kc, kd, _ = jax.random.split(k_fwd, 4)
    k_wd, k_do = jax.random.split(kd)
    draws = {"eps": jax.random.normal(kz, (n, jm.z_dim)),
             "c_bits": jax.random.bernoulli(kc, 0.5, (n,)),
             "word_drop": jax.random.bernoulli(k_wd, 0.3, (n, T)),
             "z_prior_mmd": jax.random.normal(k_mmd, (n, jm.z_dim)),
             "z_prior_rf": jax.random.normal(k_rf, (n, jm.z_dim))}
    if jm.G_class == "gru":
        draws["out_keep"] = jax.random.bernoulli(k_do, 0.7,
                                                 (n, T, jm.h_dec))
    return {k: t_(v) for k, v in draws.items()}


def check_loss_fn(argv, T, z_regu="mmdrf", seed=4, zero=(), zero_rel=0.0):
    """make_loss_fn's loss, metrics and every gradient against the JAX
    package's at its params and draws (``assert_grads``, ``zero`` the
    decoder's leaves whose exact gradient is 0); returns the port's
    gradients."""
    jcfg, tcfg, jm, tm = models(list(argv) + ["--vae.z_regu_loss", z_regu],
                                T)
    jparams = jm.init_params(jax.random.PRNGKey(seed))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(seed + 1), jm.z_dim, 16)
    key = jax.random.PRNGKey(seed + 2)
    text = tokens(seed + 3, T)
    j_loss = j_make_loss_fn(jm, jcfg.vae, jcfg.losses.wae_mmd, rf)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jparams, key, jnp.asarray(text), 1.25)
    tparams = to_port(jparams, grad=True)
    t_loss = t_tv.make_loss_fn(tm, tcfg.vae, tcfg.losses.wae_mmd,
                               tuple(t_(a) for a in rf))
    tl, tmet, tg = t_tv.loss_and_grads(t_loss, tparams, t_(text), 1.25,
                                       jax_draws(jm, key, B, T))
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    jflat = j_ck._flatten(jg)
    tflat = t_ck.flatten(tg)
    assert {t_ck.keystr(p) for p in tflat} == {
        k for k in jflat if not k.startswith("['clf']")}
    assert_grads(tflat, jflat, zero, zero_rel, prefix="['dec']")
    return tg


def check_flat_state(argv, T, tmp_path):
    """The port's flat Adam state of this model, after one step, loads
    into the JAX package's checkpoints.load with its full flat template:
    m and v as long as the template's, the port's segments bit for bit,
    the classifier's 0, the JAX flat update runs on it."""
    _, _, jm, _ = models(argv, T)
    jparams = jm.init_params(jax.random.PRNGKey(4))
    tparams = to_port(jparams)
    opt = t_opt.FlatAdam(1e-3, 5.0)
    ts = opt.init(tparams)
    opt.step(tparams, jax.tree.map(lambda p: 0.5 * torch.ones_like(p),
                                   tparams), ts)
    path = str(tmp_path / "model_3.npz")
    t_ck.save(path, tparams, ts, step=3)
    template = {"params": jparams, "opt": flat_adam(1e-3, 5.0).init(jparams)}
    back = j_ck.load(path, template, strict=False)
    _, unravel = ravel_pytree(jparams)
    for name in ("m", "v"):
        vec = getattr(back["opt"], name)
        assert vec.shape == ravel_pytree(jparams)[0].shape
        seg = {k: np.asarray(v).reshape(-1) for k, v in
               j_ck._flatten(unravel(jnp.asarray(vec))).items()}
        got = np.concatenate([seg[t_ck.keystr(p)]
                              for p in t_ck.ravel_order(tparams)])
        np.testing.assert_array_equal(got, ts[name].numpy())
        assert not any(np.any(v) for k, v in seg.items()
                       if k.startswith("['clf']"))
    flat = j_ck._flatten(back["params"])
    for p, v in t_ck.flatten(tparams).items():
        np.testing.assert_array_equal(np.asarray(flat[t_ck.keystr(p)]),
                                      v.numpy())
    upd, state = flat_adam(1e-3, 5.0).update(
        jax.tree.map(jnp.ones_like, back["params"]), back["opt"])
    assert np.isfinite(np.asarray(ravel_pytree(upd)[0])).all()
    assert int(state.count) == 2
    return tparams


def tiny_cli(argv, tmp_path, name):
    """main --tiny 1 --phase 1 --dataset synthetic --device cpu with the
    option's flags at the small widths: checkpoints with their Adam
    moments, vae_gen.txt, finite logged losses. Returns (cfg, the last
    checkpoint's keys)."""
    cfg = t_main.main(SMALL + [
        "--tiny", "1", "--phase", "1", "--dataset", "synthetic", "--device",
        "cpu", "--runname", name, "--savepath_toplevel",
        str(tmp_path / "out"), "--tb_toplevel", str(tmp_path / "tb"),
        "--datapath", str(tmp_path / "data")] + list(argv))
    run = cfg.savepath
    with np.load(os.path.join(run, "model_100.npz")) as data:
        assert int(data["['opt'][1][0].count"]) == 101
        keys = set(data.files)
    with open(os.path.join(run, "vae_gen.txt")) as fh:
        assert len(fh.read().splitlines()) == cfg.evals.sample_size
    with open(os.path.join(run, "result.json")) as fh:
        rows = [r for r in json.load(fh) if "train_L_vae" in r]
    assert rows and all(math.isfinite(r[k]) for r in rows for k in r)
    return cfg, keys


# ---- skip connections -------------------------------------------------------

def test_skip_decoder_and_step_match_jax():
    """The teacher-forced logits (train, the JAX masks injected) and one
    free-running step from hard and soft tokens."""
    _, _, jm, tm = models(SKIP, 7)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = to_port(jp)
    assert set(tp["dec"]) == {"gru", "out", "skip_x", "skip_z"}
    z, c = latents(2, B)
    tok = tokens(3, 7)
    kd = jax.random.PRNGKey(5)
    want = j_dec.apply_teacher_forced(
        jp["dec"], jp["emb"], jnp.asarray(tok), jnp.asarray(z),
        jnp.asarray(c), kd, True, skip_connections=True)
    k_wd, k_do = jax.random.split(kd)
    got = t_dec.apply_teacher_forced(
        tp["dec"], tp["emb"], t_(tok), t_(z), t_(c), True,
        word_drop=t_(jax.random.bernoulli(k_wd, 0.3, tok.shape)),
        out_keep=t_(jax.random.bernoulli(k_do, 0.7, (B, 7, 8))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    h = np.random.default_rng(6).standard_normal((B, 8)).astype(np.float32)
    soft = np.random.default_rng(7).dirichlet(np.ones(V), B).astype(
        np.float32)
    for hard, sft in ((tok[:, 2], None), (tok[:, 2], soft)):
        wl, wh = j_dec.apply_step(
            jp["dec"], jp["emb"], jnp.asarray(hard),
            None if sft is None else jnp.asarray(sft), jnp.asarray(z),
            jnp.asarray(c), jnp.asarray(h), skip_connections=True)
        gl, gh = t_dec.apply_step(tp["dec"], tp["emb"], t_(hard),
                                  None if sft is None else t_(sft), t_(z),
                                  t_(c), t_(h))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("z_regu", ["mmdrf", "kl"])
def test_skip_loss_fn_matches_jax(z_regu, one_thread):
    grads = check_loss_fn(SKIP, 7, z_regu)
    for name in ("skip_x", "skip_z"):
        assert float(grads["dec"][name]["b"].abs().sum()) > 0


def test_skip_beam_equals_jax_xla_beam(one_thread):
    """64 sentences, K 5, T 25: the route is the plain version (the model
    is outside B1's scope, as the JAX package's ``applicable`` says), the
    tokens of every hypothesis equal the JAX XLA beam's, scores within
    1e-5; generate_sentences takes that route unasked."""
    _, _, jm, tm = models(SKIP, 25)
    jp = jm.init_params(jax.random.PRNGKey(8))
    tp = to_port(jp)
    z, c = latents(9, 64)
    assert not t_beam.in_kernel_scope(tm, tp, t_(z), 5)
    want_h, want_s = j_beam.beam_search(jm, jp, jnp.asarray(z),
                                        jnp.asarray(c), beam_size=5,
                                        n_best=3)
    got_h, got_s = t_beam.beam_search(tm, tp, t_(z), t_(c), beam_size=5,
                                      n_best=3, plain=True)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-5)
    assert len({tuple(r) for r in got_h[:, 0].tolist()}) > 1
    runs = t_beam.beam_search.plain_runs
    sent, _, _ = generate_sentences(tm, tp, 64, z=t_(z), c=t_(c),
                                    sample_mode="beam", n_best=3)
    assert t_beam.beam_search.plain_runs == runs + 1
    np.testing.assert_array_equal(sent.numpy(), np.asarray(want_h))


def test_skip_phase2_attribute_loss_matches_jax(one_thread):
    """Phase 2's attribute sub-loss (the soft sampler steps the skip head,
    encode(soft) and the classifier read its rows), its metrics and the
    decoder group's gradients against the JAX full step's ``g_attr_loss``
    at the same params and draws."""
    jcfg, tcfg, jm, tm = p2_models(SKIP)
    jparams = jm.init_params(jax.random.PRNGKey(20))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(21), jm.z_dim, 16)
    key = jax.random.PRNGKey(22)
    jg, jmet = jax.jit(jax.grad(_jax_parts(jm, jcfg, rf)["g_attr_loss"],
                                has_aux=True), static_argnums=2)(
        jparams, jax.random.split(key, 3)[1], B, 0.8)
    draws = jax_full_draws(jm, jcfg, key, B, B)
    _, attr, _ = t_full.make_full_losses(tm, tcfg.full, tcfg.losses.wae_mmd,
                                         tuple(t_(a) for a in rf))
    tp = p2_to_port(jparams)
    loss, tmet = attr(tp, 0.8, draws["attr"])
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    _assert_group_grads(t_full.group_grads(loss, tp, ("G",)), jg, ("G",))


def test_skip_tiny_cli_run_and_flat_state(tmp_path, one_thread):
    _, keys = tiny_cli(SKIP, tmp_path, "skip")
    assert {"['params']['dec']['skip_x']['b']",
            "['opt'][1][0].mu['dec']['skip_z']['w']"} <= keys
    check_flat_state(SKIP, 7, tmp_path)


def test_beam_canary_checks_only_kernel_rounds():
    """A collapsed round on the card trips the canary for a model that B1
    decodes; a skip model's and a deconv model's rounds (the plain and the
    replay beam) are not checked, as the JAX package checks only a live
    kernel route."""
    from controlled_peptide_generation_tpu_torch import pipeline
    cfg, _, _ = TC.parse_and_finalize([])
    for argv, checked in (([], True), (SKIP, False),
                          (["--model.G_args.G_class", "deconv"], False)):
        _, _, _, tm = models(argv, 25)
        tp = tm.init_params(torch.Generator().manual_seed(0))
        if checked:
            with pytest.raises(pipeline.BeamCanaryError):
                pipeline.beam_canary_check(cfg, "cuda", 5000, 10, model=tm,
                                           params=tp)
        else:
            assert pipeline.beam_canary_check(cfg, "cuda", 5000, 10,
                                              model=tm, params=tp) is False
