"""Phase-2 training of the port against the JAX package on the CPU, GRU
family, at a small size (V 13, T 7, B 4, z 6, emb 10, encoder h 5, the
classifier's 4 filters a width): the text-CNN on tokens and soft rows,
each soft sampling mode (tokens, soft rows, the gradient of a scalar of
the soft rows with respect to the decoder), each sub-loss of the full
step and its gradients at the JAX package's params of that sub-stage
(before the VAE update, after it, after the attribute update) with the
JAX draws recreated from its key splits and injected, the three Adams
(opt_G twice an iteration) on identical gradients, checkpoints both ways,
and a tiny CLI run of --phase -1 and --phase 2.

The JAX sub-losses are the closures of its ``make_full_step``'s
``one_iter``, each gradient jitted alone (no jit of the whole step). Tolerances: losses and metrics
rtol 1e-5; module outputs and soft rows rtol 1e-5 / atol 1e-6;
gradients within 1e-4 of each tensor's largest entry."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.ops import sampling as j_samp
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train import train_full as j_full

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import sampling as t_samp
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_full as t_full

LOSS_TOL = dict(rtol=1e-5, atol=0)
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4
V, TLEN, B = 13, 7, 4
SMALL = ["--model.z_dim", "6", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "5", "--max_seq_len", str(TLEN),
         "--model.C_args.num_filters", "4", "--losses.wae_mmd.rf_dim", "16",
         "--phase", "2"]
MODES = ("none_softmax", "greedy_softmax", "categorical_softmax")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(argv=()):
    jcfg, _, _ = JC.parse_and_finalize(SMALL + list(argv))
    tcfg, _, _ = TC.parse_and_finalize(SMALL + list(argv))
    return (jcfg, tcfg, j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN),
            t_build(tcfg.model, n_vocab=V, max_seq_len=TLEN))


def _to_port(jparams):
    """JAX params (the classifier included) -> the port's tensors, each
    requiring grad."""
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": jparams}).items()}
    tp = t_ck.params_from_jax(flat)
    for leaf in t_ck.flatten(tp).values():
        leaf.requires_grad_(True)
    return tp


def _tokens(seed, n=B):
    rng = np.random.default_rng(seed)
    tok = np.full((n, TLEN), 1, np.int32)
    for row in range(n):
        k = int(rng.integers(1, TLEN - 1))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_grad(got, want, what):
    """Within GRAD_REL of the JAX gradient's largest entry."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max(initial=0.0))
    assert err <= GRAD_REL * scale, (what, err, scale)


def _assert_group_grads(tgrads, jgrads, names):
    """The port's group gradients (``group_grads``) against the JAX
    gradient tree, leaf by leaf, for every group in ``names``."""
    jflat = j_ck._flatten(jgrads)
    for n in names:
        flat = t_ck.flatten(tgrads[n])
        assert {t_ck.keystr(p) for p in flat} == {
            k for k in jflat if k.startswith(tuple(
                f"['{g}']" for g in t_full.GROUPS[n]))}
        for p, g in flat.items():
            _assert_grad(g, jflat[t_ck.keystr(p)], t_ck.keystr(p))


def _jax_parts(jm, jcfg, rf):
    """The JAX full step's sub-losses, optimizers and mask: the closure
    of its ``one_iter``."""
    _, _, one_iter = j_full.make_full_step(jm, jcfg.full, jcfg.losses, rf,
                                           donate=False)
    return dict(zip(one_iter.__code__.co_freevars,
                    (c.cell_contents for c in one_iter.__closure__)))


def _decoder_draws(jm, kd, n):
    """The teacher-forced decoder's draws for key kd (GRU: word dropout
    and the head's mask; transformer: word dropout and its blocks')."""
    t_args = dict(jm.dec_tfm_args)
    if jm.G_class == "transformer":
        k_wd, k_blocks = jax.random.split(kd)
        out = {"word_drop": jax.random.bernoulli(
            k_wd, t_args.get("p_word_dropout", 0.3), (n, TLEN))}
        p = t_args.get("p_dropout", 0.0)
        if p > 0:
            out["dec_keeps"] = [jax.random.bernoulli(
                k, 1.0 - p, (n, TLEN + 1, t_args["d_model"]))
                for k in jax.random.split(k_blocks, t_args["n_layers"])]
        return out
    k_wd, k_do = jax.random.split(kd)
    return {"word_drop": jax.random.bernoulli(k_wd, 0.3, (n, TLEN)),
            "out_keep": jax.random.bernoulli(k_do, 0.7, (n, TLEN, jm.h_dec))}


def _encoder_draws(jm, ke, n):
    t_args = dict(jm.enc_tfm_args)
    p = t_args.get("p_dropout", 0.0)
    if jm.E_class != "transformer" or p <= 0:
        return {}
    return {"enc_keeps": [jax.random.bernoulli(
        k, 1.0 - p, (n, TLEN, t_args["d_model"]))
        for k in jax.random.split(ke, t_args["n_layers"])]}


def _tree(draws):
    return {k: ([_t(a) for a in v] if isinstance(v, list) else _t(v))
            for k, v in draws.items()}


def jax_full_draws(jm, jcfg, key, n, n_lab):
    """The draws of the JAX one_iter (train_full.py: k1, k2, k3 and each
    sub-loss's splits) for this key, as the port's draw_full_step dicts."""
    k1, k2, k3 = jax.random.split(key, 3)
    k_fwd, k_mmd, k_rf = jax.random.split(k1, 3)
    kz, _, kd, ke = jax.random.split(k_fwd, 4)
    vae = {"eps": jax.random.normal(kz, (n, jm.z_dim)),
           "z_prior_mmd": jax.random.normal(k_mmd, (n, jm.z_dim)),
           "z_prior_rf": jax.random.normal(k_rf, (n, jm.z_dim)),
           **_decoder_draws(jm, kd, n), **_encoder_draws(jm, ke, n)}
    out = {"vae": _tree(vae)}
    c_args = dict(jm.C_args)
    n_feats = c_args["num_filters"] * 3
    for name, k, m, mode in (
            ("attr", k2, n, jcfg.full.G_soft_sample_kwargs.sample_mode),
            ("clf", k3, n_lab, jcfg.full.C_hard_sample_kwargs.sample_mode)):
        kz, kc, ks = jax.random.split(k, 3)
        d = {"z": jax.random.normal(kz, (m, jm.z_dim)),
             "c_bits": jax.random.bernoulli(kc, 0.5, (m,))}
        if "categorical" in mode:
            d["noise"] = np.stack([np.array(jax.random.gumbel(kk, (m, V)))
                                   for kk in jax.random.split(ks, TLEN)])
        if name == "clf":
            d["keep"] = jax.random.bernoulli(k3, 0.5, (m, n_feats))
        out[name] = _tree(d)
    return out


def jax_stages(jm, jcfg, rf, jparams, key, text, lab_text, lab_y, beta,
               temp):
    """The JAX one_iter unrolled by hand: [(params, grads, metrics)] of the
    VAE loss at the starting params, of the attribute loss after the VAE
    update, and of the classifier loss after the attribute update."""
    P = _jax_parts(jm, jcfg, rf)
    k1, k2, k3 = jax.random.split(key, 3)
    oE, oG, oC = (P[o].init(jparams) for o in ("opt_E", "opt_G", "opt_C"))
    params, out = jparams, []
    g, m = jax.jit(jax.grad(P["vae_loss"], has_aux=True))(
        params, k1, jnp.asarray(text), beta)
    out.append((params, g, m))
    upd, oE = P["opt_E"].update(P["masked"](g, ("emb", "enc", "flow")), oE,
                                params)
    params = optax.apply_updates(params, upd)
    upd, oG = P["opt_G"].update(P["masked"](g, ("dec",)), oG, params)
    params = optax.apply_updates(params, upd)
    g, m = jax.jit(jax.grad(P["g_attr_loss"], has_aux=True),
                   static_argnums=2)(params, k2, text.shape[0], temp)
    out.append((params, g, m))
    upd, oG = P["opt_G"].update(P["masked"](g, ("dec",)), oG, params)
    params = optax.apply_updates(params, upd)
    g, m = jax.jit(jax.grad(P["c_loss"], has_aux=True))(
        params, k3, jnp.asarray(lab_text), jnp.asarray(lab_y), temp)
    out.append((params, g, m))
    return out


def check_full_step(argv, one_seed=20):
    """Each sub-loss, its metrics and its groups' gradients against the
    JAX stages (the body of the per-family tests)."""
    jcfg, tcfg, jm, tm = _models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(one_seed))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(one_seed + 1), jm.z_dim, 16)
    key = jax.random.PRNGKey(one_seed + 2)
    text, lab_text = _tokens(one_seed + 3), _tokens(one_seed + 4)
    lab_y = np.random.default_rng(one_seed + 5).integers(0, 2, B).astype(
        np.int32)
    beta, temp = 1.5, 0.8
    stages = jax_stages(jm, jcfg, rf, jparams, key, text, lab_text, lab_y,
                        beta, temp)
    draws = jax_full_draws(jm, jcfg, key, B, B)
    vae, attr, clf = t_full.make_full_losses(
        tm, tcfg.full, tcfg.losses.wae_mmd, tuple(_t(a) for a in rf))
    calls = (
        (lambda p: vae(p, _t(text), beta, draws["vae"]), ("E", "G")),
        (lambda p: attr(p, temp, draws["attr"]), ("G",)),
        (lambda p: clf(p, _t(lab_text), _t(lab_y), temp, draws["clf"]),
         ("C",)))
    for (jp, jg, jmet), (fn, names) in zip(stages, calls):
        tp = _to_port(jp)
        loss, tmet = fn(tp)
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                       err_msg=k, **LOSS_TOL)
        _assert_group_grads(t_full.group_grads(loss, tp, names), jg, names)


# ---- the classifier ---------------------------------------------------------

@pytest.mark.parametrize("soft,train", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_classifier_matches_jax(soft, train):
    _, _, jm, tm = _models()
    jparams = jm.init_params(jax.random.PRNGKey(1))
    tp = _to_port(jparams)
    if soft:
        logits = np.random.default_rng(2).standard_normal(
            (B, TLEN, V)).astype(np.float32)
        x = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    else:
        x = _tokens(3)
    key = jax.random.PRNGKey(4)
    want = jm.classify(jparams, jnp.asarray(x), key=key, train=train)
    keep = jax.random.bernoulli(key, 0.5, (B, 12))
    got = tm.classify(tp, _t(x), train=train, keep=_t(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_classifier_init_and_scope():
    """The classifier's tree is classifier_shapes' layout, its entries
    within the JAX init's bounds; a sequence shorter than the widest
    filter raises."""
    _, tcfg, jm, tm = _models()
    clf = tm.init_classifier(torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in t_ck.flatten(clf).items()}
    assert shapes == t_ck.classifier_shapes(10, **tcfg.model.C_args)
    jclf = jm.init_params(jax.random.PRNGKey(0))["clf"]
    assert {t_ck.keystr(p) for p in shapes} == set(j_ck._flatten(jclf))
    assert float(clf["conv3"]["w"].abs().max()) <= 1 / math.sqrt(30)
    assert float(clf["fc"]["w"].abs().max()) <= 1 / math.sqrt(12)
    with pytest.raises(ValueError, match="seq_len"):
        tm.classify({"emb": {"w": torch.zeros(V, 10)}, "clf": clf},
                    torch.zeros((2, 4), dtype=torch.long))


# ---- the soft sampling modes ------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_soft_sampler_matches_jax(mode, one_thread):
    """Tokens equal, soft rows rtol 1e-5, and the gradient of a weighted
    sum of the soft rows with respect to every decoder leaf."""
    _, _, jm, tm = _models()
    jparams = jm.init_params(jax.random.PRNGKey(5))
    tp = _to_port(jparams)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((B, 6)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    w = rng.standard_normal((B, TLEN + 1, V)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def scalar(p):
        tok, soft = j_samp.sample_sentences(
            jm, p, key, jnp.asarray(z), jnp.asarray(c), sample_mode=mode,
            temp=0.9)
        return jnp.sum(soft * w), (tok, soft)

    jg, (jtok, jsoft) = jax.grad(scalar, has_aux=True)(jparams)
    noise = np.stack([np.array(jax.random.gumbel(k, (B, V)))
                      for k in jax.random.split(key, TLEN)])
    tok, soft = t_samp.sample_sentences(tm, tp, _t(z), _t(c),
                                        sample_mode=mode, temp=0.9,
                                        noise=_t(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(jsoft),
                               **TOL)
    if mode == "none_softmax":
        assert (tok == 2).all()          # the hard track never moves
    else:
        assert (soft.detach().sum(-1) == 0).any()    # finished rows zeroed
    dec = t_ck.flatten(tp["dec"])
    grads = torch.autograd.grad((soft * _t(w)).sum(), list(dec.values()))
    jflat = j_ck._flatten(jg["dec"])
    for p, g in zip(dec, grads):
        _assert_grad(g, jflat[t_ck.keystr(p)], t_ck.keystr(p))


def test_soft_modes_refuse_prevent_empty():
    _, _, _, tm = _models()
    tp = tm.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="prevent_empty"):
        t_samp.sample_sentences(tm, tp, torch.zeros(2, 6),
                                torch.eye(2), sample_mode="none_softmax",
                                prevent_empty=True)


# ---- the full step ----------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--full.z_regu_loss", "mmd", "--full.G_soft_sample_kwargs.sample_mode",
     "categorical_softmax", "--full.C_hard_sample_kwargs.sample_mode",
     "greedy"],
])
def test_full_step_sub_losses_match_jax(argv, one_thread):
    check_full_step(argv)


def test_optimizers_match_the_masked_optax_updates():
    """Two iterations of opt_E, opt_G (twice) and opt_C on identical
    gradients: the port's group Adams against the JAX step's masked optax
    updates over the whole tree (params, moments and counts); the first
    gradients are clipped."""
    jcfg, tcfg, jm, tm = _models()
    jparams = jm.init_params(jax.random.PRNGKey(8))
    P = _jax_parts(jm, jcfg, j_L.init_rf_basis(jax.random.PRNGKey(9), 6, 16))
    tp = _to_port(jparams)
    step = t_full.FullStep(tm, tcfg.full, tcfg.losses, (None, None))
    states = step.init(tp)
    jstates = {n: P[f"opt_{n}"].init(jparams) for n in "EGC"}
    rng = np.random.default_rng(10)
    for scale in (3.0, 0.01):
        for n in ("E", "G", "G", "C"):
            g = jax.tree.map(lambda a: (scale * rng.standard_normal(
                a.shape)).astype(np.float32), jparams)
            upd, jstates[n] = P[f"opt_{n}"].update(
                P["masked"](jax.tree.map(jnp.asarray, g),
                            t_full.GROUPS[n]), jstates[n], jparams)
            jparams = optax.apply_updates(jparams, upd)
            tg = {k: jax.tree.map(_t, v) for k, v in g.items()
                  if k in t_full.GROUPS[n]}
            step.opts[n].step(t_full.group(tp, n), tg, states[n])
    jflat = j_ck._flatten(jparams)
    for p, v in t_ck.flatten(tp).items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   np.asarray(jflat[t_ck.keystr(p)]), **TOL)
    for n in "EGC":
        adam = jstates[n][1][0]
        assert int(states[n]["count"]) == int(adam.count) == (
            4 if n == "G" else 2)
        mu = j_ck._flatten(adam.mu)
        for p, v in t_ck.flatten(states[n]["mu"]).items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(mu[t_ck.keystr(p)]), **TOL)


# ---- checkpoints --------------------------------------------------------------

def test_phase2_checkpoints_cross_both_ways(tmp_path):
    """The JAX loader reads the port's phase-2 file (params with clf, and
    the step) strictly; the port's phase-2 load keeps its fresh classifier
    over a port phase-1 file and takes the classifier of a JAX file."""
    _, _, jm, tm = _models()
    gen = torch.Generator().manual_seed(11)
    tp = tm.init_params(gen)
    tp["clf"] = tm.init_classifier(gen)
    path = str(tmp_path / "model_9.npz")
    t_ck.save(path, tp, step=9)
    template = {"params": jm.init_params(jax.random.PRNGKey(0)),
                "step": jnp.asarray(0)}
    back = j_ck._flatten(j_ck.load(path, template, strict=True))
    for p, v in t_ck.flatten(tp).items():
        np.testing.assert_array_equal(
            np.asarray(back[t_ck.keystr(("params",) + p)]), v.numpy())
    assert int(back["['step']"]) == 9

    fresh = tm.init_params(torch.Generator().manual_seed(12))
    fresh["clf"] = tm.init_classifier(torch.Generator().manual_seed(13))
    p1 = str(tmp_path / "model_1.npz")
    t_ck.save(p1, tm.init_params(torch.Generator().manual_seed(14)))
    got = t_ck.load_params(p1, fresh)
    for p, v in t_ck.flatten(got).items():
        src = fresh if p[0] == "clf" else t_ck.load(p1)
        assert torch.equal(v, t_ck.flatten(src)[p])
    jparams = jm.init_params(jax.random.PRNGKey(15))
    pj = str(tmp_path / "model_jax.npz")
    j_ck.save(pj, {"params": jparams, "step": jnp.asarray(3)})
    got = t_ck.flatten(t_ck.load_params(pj, fresh))
    for k, v in j_ck._flatten({"params": jparams}).items():
        np.testing.assert_array_equal(
            got[t_ck.parse_keystr(k)[1:]].numpy(), np.asarray(v))


# ---- the CLI ----------------------------------------------------------------

def test_phase_minus_1_and_phase_2_cli(tmp_path, one_thread):
    """main --phase -1 on the synthetic corpus at a small width: both
    phases' files, a phase-2 checkpoint with the classifier, full_ rows in
    result.json; then --phase 2 alone loads the run's phase-1 checkpoint
    (no classifier) and trains from it."""
    base = ["--dataset", "synthetic", "--device", "cpu", "--runname", "p2",
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data"),
            "--model.z_dim", "6", "--model.emb_dim", "10",
            "--model.E_args.h_dim", "5", "--model.C_args.num_filters", "4",
            "--max_seq_len", "10", "--losses.wae_mmd.rf_dim", "16",
            "--vae.batch_size", "4", "--vae.n_iter", "4", "--full.n_iter", "4",
            "--vae.cheaplog_every", "2", "--vae.expsvlog_every", "4",
            "--full.cheaplog_every", "2", "--full.expsvlog_every", "2",
            "--evals.sample_size", "6", "--resume_result_json", "0"]
    cfg = t_main.main(base + ["--phase", "-1"])
    run = cfg.savepath
    for name in ("vae_gen.txt", "full_gen.txt", "full_samez.txt",
                 "full_posz.txt", "full_interp.txt", "full_gen.fasta",
                 "pos_gen.fasta", "model_4.npz", "model_8.npz"):
        assert os.path.exists(os.path.join(run, name)), name
    with open(cfg.full.gen_samples_path) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == 12 and all(
        ln in ("label: 0", "label: 1") for ln in lines[::2])
    with open(cfg.full.samez_samples_path) as fh:
        samez = fh.read().splitlines()
    assert len(samez) == 64 and samez[0].startswith("c=0: ")
    with open(cfg.full.interp_samples_path) as fh:
        assert len(fh.read().splitlines()) == 11
    with np.load(os.path.join(run, "model_8.npz")) as data:
        assert int(data["['step']"]) == 8
        assert "['params']['clf']['fc']['w']" in data.files
        assert not any(k.startswith("['opt']") for k in data.files)
    with np.load(os.path.join(run, "model_4.npz")) as data:
        assert not any("['clf']" in k for k in data.files)
    with open(os.path.join(run, "result.json")) as fh:
        rows = json.load(fh)
    full = [r for r in rows if "full_L_vae" in r]
    assert [r["it"] for r in full] == [4, 6, 8]
    assert all(math.isfinite(r[k]) for r in full for k in r)
    assert {"full_L_attr_c", "full_L_attr_z", "full_L_clf_sup",
            "full_clf_acc", "full_L_wae_mmdrf", "full_softmax_temp"} <= set(
                full[0])
    assert "full_steps_per_sec" in rows[-1]

    cfg2 = t_main.main(base + ["--phase", "2"])
    assert cfg2.loadpath == os.path.join(run, "model_4.npz")
    with np.load(os.path.join(run, "model_8.npz")) as data:
        assert int(data["['step']"]) == 8
