"""Phase-1 training of the port against the JAX package on the CPU, at a
small size: the encoder and teacher-forced decoder, make_loss_fn (loss,
metrics and every gradient at the same params, batch and draws — the
draws recreated from the JAX key splits and injected), the optimizer
against optax, checkpoints both ways with the Adam moments, the data
loader, the hard-mode sampler, and a tiny CLI run.

Tolerances: loss and metrics rtol 1e-5; gradients rtol 1e-4 / atol 1e-5;
optimizer and module outputs rtol 1e-5 / atol 1e-6 (fp32 sums in other
orders)."""

import contextlib
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
from controlled_peptide_generation_tpu.data import AttributeDataLoader as JL
from controlled_peptide_generation_tpu.data import synthetic as j_syn
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.models import decoder as j_dec
from controlled_peptide_generation_tpu.models import encoder as j_enc
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.ops import sampling as j_samp
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train.train_vae import (
    make_loss_fn as j_make_loss_fn)

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.data.loader import (
    AttributeDataLoader as TL)
from controlled_peptide_generation_tpu_torch.models import decoder as t_dec
from controlled_peptide_generation_tpu_torch.models import encoder as t_enc
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import sampling as t_samp
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import opt as t_opt
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)
V, TLEN, B = 13, 7, 4
SMALL = ["--model.z_dim", "6", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "5", "--max_seq_len", str(TLEN),
         "--losses.wae_mmd.rf_dim", "16", "--phase", "1"]


@pytest.fixture
def one_thread():
    """torch on one CPU thread: the tiny shapes here are faster so, and a
    worker of a parallel test run does not fight the others for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _to_port(jparams):
    """JAX params -> the port's tensors (the classifier left out)."""
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jparams.items() if k != "clf"}}).items()}
    return t_ck.params_from_jax(flat)


def _models(argv=()):
    jcfg, _, _ = JC.parse_and_finalize(SMALL + list(argv))
    tcfg, _, _ = TC.parse_and_finalize(SMALL + list(argv))
    jm = j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN)
    tm = t_build(tcfg.model, n_vocab=V, max_seq_len=TLEN)
    return jcfg, tcfg, jm, tm


def _tokens(seed, n=B):
    rng = np.random.default_rng(seed)
    tok = np.full((n, TLEN), 1, np.int32)
    for row in range(n):
        k = int(rng.integers(1, TLEN - 1))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def test_encoder_matches_jax():
    key = jax.random.PRNGKey(0)
    jp = j_enc.init(key, emb_dim=10, h_dim=5, z_dim=6)
    tp = t_ck.params_from_jax({k: np.asarray(v)
                               for k, v in j_ck._flatten(jp).items()})
    emb = np.random.default_rng(1).standard_normal((B, TLEN, 10)).astype(
        np.float32)
    want = j_enc.apply(jp, jnp.asarray(emb), h_dim=5)
    got = t_enc.apply(tp, torch.from_numpy(emb), h_dim=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_teacher_forced_decoder_matches_jax():
    key = jax.random.PRNGKey(1)
    kp, ke, kd = jax.random.split(key, 3)
    from controlled_peptide_generation_tpu.ops import nn as j_nn
    jdec = j_dec.init(kp, emb_dim=10 + 8, output_dim=V, h_dim=8)
    jemb = j_nn.init_embedding(ke, V, 10)
    tdec, temb = (t_ck.params_from_jax({k: np.asarray(v) for k, v in
                                        j_ck._flatten(p).items()})
                  for p in (jdec, jemb))
    rng = np.random.default_rng(2)
    tok = _tokens(3)
    z = rng.standard_normal((B, 6)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    want = j_dec.apply_teacher_forced(jdec, jemb, jnp.asarray(tok),
                                      jnp.asarray(z), jnp.asarray(c), kd,
                                      True)
    k_wd, k_do = jax.random.split(kd)
    drop = np.array(jax.random.bernoulli(k_wd, 0.3, tok.shape))
    keep = np.array(jax.random.bernoulli(k_do, 0.7, (B, TLEN, 8)))
    T = torch.from_numpy
    got = t_dec.apply_teacher_forced(tdec, temb, T(tok), T(z), T(c), True,
                                     word_drop=T(drop), out_keep=T(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_draws(model, key, text):
    """The draws of the JAX loss_fn (train_vae.py:52) and forward
    (rnn_vae.py:263) for this key, as the port's draws dict."""
    k_fwd, k_mmd, k_rf, _ = jax.random.split(key, 4)
    kz, kc, kd, _ = jax.random.split(k_fwd, 4)
    k_wd, k_do = jax.random.split(kd)
    n, Z, H = text.shape[0], model.z_dim, model.h_dec
    draws = {
        "eps": jax.random.normal(kz, (n, Z)),
        "c_bits": jax.random.bernoulli(kc, 0.5, (n,)),
        "word_drop": jax.random.bernoulli(k_wd, 0.3, text.shape),
        "out_keep": jax.random.bernoulli(k_do, 0.7, (n, TLEN, H)),
        "z_prior_mmd": jax.random.normal(k_mmd, (n, Z)),
        "z_prior_rf": jax.random.normal(k_rf, (n, Z)),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("z_regu,plain", [("mmdrf", False), ("mmd", False),
                                          ("kl", False), ("mmdrf", True)])
def test_loss_fn_matches_jax(z_regu, plain, one_thread):
    jcfg, tcfg, jm, tm = _models(["--vae.z_regu_loss", z_regu])
    jparams = jm.init_params(jax.random.PRNGKey(4))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(5), 6, 16)
    key = jax.random.PRNGKey(6)
    text = _tokens(7)
    beta = 1.25
    j_loss = j_make_loss_fn(jm, jcfg.vae, jcfg.losses.wae_mmd, rf)
    (jl, jmet), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jparams, key, jnp.asarray(text), beta)

    tparams = _to_port(jparams)
    for leaf in t_ck.flatten(tparams).values():
        leaf.requires_grad_(True)
    t_loss = t_tv.make_loss_fn(tm, tcfg.vae, tcfg.losses.wae_mmd,
                               tuple(torch.from_numpy(np.array(a))
                                     for a in rf))
    with cuda_build.plain() if plain else contextlib.nullcontext():
        tl, tmet, tg = t_tv.loss_and_grads(
            t_loss, tparams, torch.from_numpy(text), beta,
            _jax_draws(tm, key, text))
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    jflat = j_ck._flatten(jg)
    tflat = t_ck.flatten(tg)
    assert {t_ck.keystr(p) for p in tflat} == {
        k for k in jflat if not k.startswith("['clf']")}
    for p, g in tflat.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jflat[t_ck.keystr(p)]),
                                   err_msg=t_ck.keystr(p), **GRAD_TOL)


def test_optimizer_matches_optax():
    """Three steps of clip(5) + Adam against optax.chain: the first
    gradient is clipped (norm > 5), the second is not."""
    rng = np.random.default_rng(8)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (s * rng.standard_normal(p.shape))
                          .astype(np.float32), params)
             for s in (4.0, 0.1, 1.0)]
    assert optax.global_norm(grads[0]) > 5 > optax.global_norm(grads[1])
    j_opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init(jp)
    t_o = t_opt.ClipAdam(1e-3, 5.0)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = t_o.init(tp)
    for g in grads:
        upd, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = t_o.step(tp, jax.tree.map(torch.from_numpy, g), ts)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        adam = js[1][0]
        assert int(ts["count"]) == int(adam.count)
        for ours, theirs in ((ts["mu"], adam.mu), (ts["nu"], adam.nu)):
            for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_flat_optimizer_trains_and_resumes(tmp_path, one_thread):
    """--hw.flat_optimizer on builds the flat-vector Adam; a tiny CLI run
    trains with it (finite losses, the flat state in its checkpoints) and
    a second run resumes from its last checkpoint, moments and count
    included."""
    cfg, _, _ = TC.parse_and_finalize(["--hw.flat_optimizer", "on"])
    assert isinstance(t_opt.make_optimizer(
        cfg.vae, TC.flat_optimizer_enabled(cfg)), t_opt.FlatAdam)
    base = ["--tiny", "1", "--phase", "1", "--dataset", "synthetic",
            "--device", "cpu", "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data"),
            "--hw.flat_optimizer", "on"]
    run = t_main.main(base + ["--runname", "flat"]).savepath
    path = os.path.join(run, "model_100.npz")
    with np.load(path) as data:
        assert int(data["['opt'].count"]) == 101
        assert not any(".mu" in k for k in data.files)
        assert float(np.abs(data["['opt'].v"]).sum()) > 0
    with open(os.path.join(run, "result.json")) as fh:
        rows = [r for r in json.load(fh) if "train_L_vae" in r]
    assert rows and all(math.isfinite(r[k]) for r in rows for k in r)
    again = t_main.main(base + ["--runname", "flat_again", "--loadpath",
                                path]).savepath
    with np.load(os.path.join(again, "model_25.npz")) as data:
        assert int(data["['opt'].count"]) == 101 + 26


def _jax_train_state(jm, seed):
    """JAX params and an optax state after two updates (nonzero
    moments)."""
    params = jm.init_params(jax.random.PRNGKey(seed))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    state = opt.init(params)
    update = jax.jit(opt.update)
    for s in (1, 2):
        g = jax.tree.map(lambda p: 0.01 * s * jnp.ones_like(p), params)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, opt, state


def test_jax_train_state_loads_into_the_port(tmp_path):
    _, _, jm, tm = _models()
    jparams, _, jstate = _jax_train_state(jm, 9)
    path = str(tmp_path / "model_7.npz")
    j_ck.save(path, {"params": jparams, "opt": jstate,
                     "step": jnp.asarray(7)})
    tp0 = tm.init_params(torch.Generator().manual_seed(0))
    opt = t_opt.ClipAdam(1e-3, 5.0)
    tp, ts = t_ck.load_train_state(path, tp0, opt.init(tp0))
    jflat = _np(j_ck._flatten({"params": jparams, "opt": jstate}))
    assert int(ts["count"]) == 2
    for p, v in t_ck.flatten({"params": tp, "opt": ts}).items():
        np.testing.assert_array_equal(v.numpy(), jflat[t_ck.state_keystr(p)])
    assert float(ts["nu"]["enc"]["gru_fwd"]["wh"].abs().sum()) > 0


def test_port_train_state_loads_into_jax(tmp_path):
    _, _, jm, tm = _models()
    jparams, jopt, jstate = _jax_train_state(jm, 10)
    tparams = _to_port(jparams)
    opt = t_opt.ClipAdam(1e-3, 5.0)
    ts = opt.init(tparams)
    g = jax.tree.map(lambda p: 0.5 * torch.ones_like(p), tparams)
    opt.step(tparams, g, ts)
    path = str(tmp_path / "model_3.npz")
    t_ck.save(path, tparams, ts, step=3)
    template = {"params": jm.init_params(jax.random.PRNGKey(0)),
                "opt": jopt.init(jparams)}
    back = j_ck.load(path, template, strict=False)
    flat = j_ck._flatten(back)
    ours = t_ck.flatten({"params": tparams, "opt": ts})
    for p, v in ours.items():
        np.testing.assert_array_equal(np.asarray(flat[t_ck.state_keystr(p)]),
                                      v.numpy())
    # the classifier keeps the template's values, as strict=False does
    want = j_ck._flatten(template)
    clf = [k for k in want if k.startswith("['params']['clf']")]
    assert clf
    for k in clf:
        np.testing.assert_array_equal(np.asarray(flat[k]),
                                      np.asarray(want[k]))
    assert int(np.load(path)["['step']"]) == 3


@pytest.mark.parametrize("dataset", ["amp", "synthetic"])
def test_loader_yields_the_jax_batches(dataset, tmp_path):
    cfg = JC.default_config()
    cfg.dataset = dataset
    cfg.datapath = str(tmp_path) if dataset == "synthetic" else "data"
    spec = JC.dataset_spec(cfg)
    gen_kwargs = spec.pop("synthetic", None)
    if gen_kwargs:
        j_syn.ensure(spec["data_path"], **gen_kwargs)
    jl = JL(mbsize=8, max_seq_len=25, **spec)
    tl = TL(mbsize=8, max_seq_len=25, **spec)
    assert jl.vocab.itos == tl.vocab.itos
    np.testing.assert_array_equal(jl.tokens, tl.tokens)
    assert list(jl.df.split) == list(tl.split)
    for name in jl.iterators:
        for _ in range(3):
            a, b = jl.next_batch(name), tl.next_batch(name)
            np.testing.assert_array_equal(a.text, b.text)
            for attr, _ in jl.attributes:
                np.testing.assert_array_equal(getattr(a, attr),
                                              getattr(b, attr))
    assert jl.idx2sentence(jl.tokens[0]) == tl.idx2sentence(tl.tokens[0])


@pytest.mark.parametrize("mode", ["greedy", "categorical"])
def test_sampler_matches_jax(mode):
    _, _, jm, tm = _models()
    jparams = jm.init_params(jax.random.PRNGKey(11))
    tparams = _to_port(jparams)
    rng = np.random.default_rng(12)
    z = rng.standard_normal((B, 6)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    key = jax.random.PRNGKey(13)
    want = j_samp.sample_sentences(jm, jparams, key, jnp.asarray(z),
                                   jnp.asarray(c), sample_mode=mode,
                                   temp=0.9, prevent_empty=True)
    noise = np.stack([np.array(jax.random.gumbel(k, (B, V)))
                      for k in jax.random.split(key, TLEN)])
    got = t_samp.sample_sentences(tm, tparams, torch.from_numpy(z),
                                  torch.from_numpy(c), sample_mode=mode,
                                  temp=0.9, prevent_empty=True,
                                  noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("argv,exc,match", [
    # a gen_prior flow cannot train (the JAX package asserts so)
    (["--phase", "1", "--model.flow", "2", "--model.flow_type", "planar"],
     ValueError, "flow_mode='posterior'"),
    # phase 2 of a flow or a deconv model: the JAX package raises too
    (["--phase", "2", "--model.flow", "2", "--model.flow_type", "planar",
      "--model.flow_mode", "posterior"], ValueError, "phase 2 with a flow"),
    (["--phase", "1", "--hw.pallas_train", "off"], ValueError, None),
    # tensor and pipeline parallelism need a group of tp x pp ranks
    (["--phase", "1", "--hw.tp", "2"], ValueError,
     "hw.tp 2 is 2 rank.s. but the process group has 1"),
    (["--phase", "2", "--model.G_args.G_class", "deconv"], ValueError,
     "phase 2 with G_class deconv"),
    (["--phase", "2", "--hw.pp", "2"], ValueError,
     "hw.pp 2 x hw.tp 1 is 2 rank.s. but the process group has 1"),
])
def test_cli_refuses_what_is_not_ported(argv, exc, match, tmp_path,
                                        one_thread):
    base = ["--tiny", "1", "--dataset", "synthetic", "--device", "cpu",
            "--savepath_toplevel", str(tmp_path / "out"), "--tb_toplevel",
            str(tmp_path / "tb"), "--datapath", str(tmp_path / "data")]
    with pytest.raises(exc, match=match):
        t_main.main(base + argv)


def test_tiny_cli_run(tmp_path, one_thread):
    """main --tiny 1 --dataset synthetic --device cpu: checkpoints every
    25 iterations with their Adam moments, samples, result.json."""
    argv = ["--tiny", "1", "--phase", "1", "--dataset", "synthetic",
            "--device", "cpu", "--runname", "t",
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data")]
    cfg = t_main.main(argv)
    run = cfg.savepath
    for it in (25, 50, 75, 100):
        assert os.path.exists(os.path.join(run, f"model_{it}.npz"))
    with np.load(os.path.join(run, "model_100.npz")) as data:
        assert int(data["['opt'][1][0].count"]) == 101
        assert int(data["['step']"]) == 100
    with open(os.path.join(run, "vae_gen.txt")) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == cfg.evals.sample_size == 30
    with open(os.path.join(run, "result.json")) as fh:
        rows = json.load(fh)
    # logs every 10 iterations (cheaplog) and at every checkpoint (25)
    logged = [r for r in rows if "train_L_vae" in r]
    assert [r["it"] for r in logged] == sorted(
        set(range(0, 101, 10)) | {25, 75})
    assert all(math.isfinite(r[k]) for r in logged for k in r)
    assert [r["it"] for r in rows if "hld_cov_frob" in r] == [25, 50, 75, 100]
    assert "train_steps_per_sec" in rows[-1]
    assert os.path.exists(os.path.join(run, "vae_result.json"))
    assert os.path.exists(os.path.join(run, "vocab.dict"))


def test_profile_union_counts_overlaps_once():
    """The device busy time of tools/profile_train: overlapping kernel
    intervals count once, gaps not at all."""
    from controlled_peptide_generation_tpu_torch.tools import profile_train
    assert profile_train._union_us([(5, 6), (0, 2), (1, 3), (2.5, 2.75)]) \
        == 4.0
    assert profile_train._union_us([]) == 0.0


def test_paired_steps_alternates_the_checkouts(monkeypatch, capsys):
    """tools/paired_steps runs base and change in the order base, change,
    change, base, ... with the flags of main.py passed to both, and
    reports each checkout's median and quartiles."""
    from controlled_peptide_generation_tpu_torch.tools import paired_steps
    order = []

    def fake_run(root, steps, flags, out):
        order.append((os.path.basename(root), steps, tuple(flags)))
        return {"steps_per_s": 100.0 + len(order), "busy_ms": 1.5}

    monkeypatch.setattr(paired_steps, "_run", fake_run)
    monkeypatch.setattr(paired_steps.runtime, "card_line", lambda: "card")
    rep = paired_steps.main(["/x/base", "/x/change", "--pairs", "4",
                             "--steps", "7", "--model.E_args.E_class",
                             "transformer"])
    flags = ("--model.E_args.E_class", "transformer")
    assert order == [(n, 7, flags) for n in (
        "base", "change", "change", "base", "base", "change", "change",
        "base")]
    assert [r["steps_per_s"] for r in rep["runs"]["base"]] == [
        101.0, 104.0, 105.0, 108.0]
    assert rep["base"]["steps_per_s"]["median"] == 104.5
    assert rep["change"]["busy_ms"] == {"median": 1.5, "q1": 1.5, "q3": 1.5}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rep
