"""Phase-1 training of the transformer family (both parts transformer)
against the JAX package on the CPU, at a small width (V 13, T 7, B 4,
z 6, emb 10, d_model 16, 2 layers, d_ff 32, 2 heads): make_loss_fn's loss,
metrics and every gradient at the same params, batch and draws (the JAX
draws recreated from its key splits and injected, the blocks' dropout
masks included), with the blocks' dropout off and on; the full train
state (params and Adam moments, list-index keys) both ways; draw_step's
masks; and a tiny CLI run.

The dropout-on case holds the encoder's block dropout: the JAX forward
trains its encoder with it (``encode(..., key=ke, train=train)``).

Tolerances: loss and metrics rtol 1e-5; gradients rtol 1e-4 / atol 1e-5
(fp32 sums in other orders)."""

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
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train.train_vae import (
    make_loss_fn as j_make_loss_fn)

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import opt as t_opt
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
V, TLEN, B, Z, D_MODEL, LAYERS = 13, 7, 4, 6, 16, 2
TFM = ["--model.E_args.E_class", "transformer",
       "--model.G_args.G_class", "transformer"]


def _flags(p_dropout=0.0):
    out = list(TFM) + ["--model.z_dim", str(Z), "--model.emb_dim", "10",
                       "--max_seq_len", str(TLEN),
                       "--losses.wae_mmd.rf_dim", "16"]
    for part in ("E_args", "G_args"):
        for k, v in (("d_model", D_MODEL), ("d_ff", 32), ("n_heads", 2),
                     ("n_layers", LAYERS), ("p_dropout", p_dropout)):
            out += [f"--model.{part}.T_args.{k}", str(v)]
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(argv=()):
    jcfg, _, _ = JC.parse_and_finalize(list(argv))
    tcfg, _, _ = TC.parse_and_finalize(list(argv))
    return (jcfg, tcfg, j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN),
            t_build(tcfg.model, n_vocab=V, max_seq_len=TLEN))


def _to_port(jparams):
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jparams.items() if k != "clf"}}).items()}
    return t_ck.params_from_jax(flat)


def _tokens(seed):
    rng = np.random.default_rng(seed)
    tok = np.full((B, TLEN), 1, np.int32)
    for row in range(B):
        k = int(rng.integers(1, TLEN - 1))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def _jax_draws(key, p_dropout):
    """The draws of the JAX loss_fn (train_vae.py:52), forward
    (rnn_vae.py:263) and transformer blocks (transformer.py:218, 260, 277)
    for this key, as the port's draws dict."""
    k_fwd, k_mmd, k_rf, _ = jax.random.split(key, 4)
    kz, kc, kd, ke = jax.random.split(k_fwd, 4)
    k_wd, k_blocks = jax.random.split(kd)
    draws = {
        "eps": jax.random.normal(kz, (B, Z)),
        "c_bits": jax.random.bernoulli(kc, 0.5, (B,)),
        "word_drop": jax.random.bernoulli(k_wd, 0.3, (B, TLEN)),
        "z_prior_mmd": jax.random.normal(k_mmd, (B, Z)),
        "z_prior_rf": jax.random.normal(k_rf, (B, Z)),
    }
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    if p_dropout > 0:
        for name, k, S in (("enc_keeps", ke, TLEN),
                           ("dec_keeps", k_blocks, TLEN + 1)):
            out[name] = [torch.from_numpy(np.array(jax.random.bernoulli(
                kk, 1.0 - p_dropout, (B, S, D_MODEL))))
                for kk in jax.random.split(k, LAYERS)]
    return out


@pytest.mark.parametrize("p_dropout,z_regu", [(0.0, "mmdrf"), (0.1, "mmdrf"),
                                              (0.1, "mmd")])
def test_transformer_loss_fn_matches_jax(p_dropout, z_regu, one_thread):
    jcfg, tcfg, jm, tm = _models(_flags(p_dropout)
                                 + ["--vae.z_regu_loss", z_regu])
    jparams = jm.init_params(jax.random.PRNGKey(4))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(5), Z, 16)
    key = jax.random.PRNGKey(6)
    text = _tokens(7)
    beta = 1.25
    j_loss = j_make_loss_fn(jm, jcfg.vae, jcfg.losses.wae_mmd, rf)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jparams, key, jnp.asarray(text), beta)

    tparams = _to_port(jparams)
    for leaf in t_ck.flatten(tparams).values():
        leaf.requires_grad_(True)
    t_loss = t_tv.make_loss_fn(tm, tcfg.vae, tcfg.losses.wae_mmd,
                               tuple(torch.from_numpy(np.array(a))
                                     for a in rf))
    tl, tmet, tg = t_tv.loss_and_grads(t_loss, tparams,
                                       torch.from_numpy(text), beta,
                                       _jax_draws(key, p_dropout))
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
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(jflat[t_ck.keystr(p)]),
                                   err_msg=t_ck.keystr(p), **GRAD_TOL)


@pytest.mark.parametrize("p_dropout", [0.0, 0.1])
def test_draw_step_gives_the_family_its_masks(p_dropout):
    """Transformer draws: no GRU out_keep; block masks of the encoder's
    [B, T, d_model] and the decoder's [B, T + 1, d_model] shapes, one per
    block, only when the blocks have dropout; a fixed generator gives the
    same draws."""
    _, tcfg, _, tm = _models(_flags(p_dropout))
    draws = [t_tv.draw_step(tm, torch.Generator().manual_seed(3), B, TLEN,
                            "cpu", rf_dim=16) for _ in range(2)]
    want = {"eps", "c_bits", "word_drop", "z_prior_mmd", "z_prior_rf",
            "rf_w", "rf_b"}
    if p_dropout > 0:
        want |= {"enc_keeps", "dec_keeps"}
        assert [tuple(k.shape) for k in draws[0]["enc_keeps"]] == [
            (B, TLEN, D_MODEL)] * LAYERS
        assert [tuple(k.shape) for k in draws[0]["dec_keeps"]] == [
            (B, TLEN + 1, D_MODEL)] * LAYERS
        share = torch.cat([k.flatten() for k in draws[0]["dec_keeps"]]
                          ).float().mean().item()
        assert 0.8 < share < 0.98
    assert set(draws[0]) == want
    for k in draws[0]:
        a, b = draws[0][k], draws[1][k]
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y)


def _jax_train_state(jm, seed):
    params = jm.init_params(jax.random.PRNGKey(seed))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    state = opt.init(params)
    update = jax.jit(opt.update)
    for s in (1, 2):
        g = jax.tree.map(lambda p: 0.01 * s * jnp.ones_like(p), params)
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, opt, state


def test_transformer_train_state_crosses_both_ways(tmp_path):
    """A JAX train state (params and Adam moments under ['blocks'][i])
    loads into the port bit for bit; the port's, after one of its Adam
    steps, loads into the JAX package bit for bit."""
    _, _, jm, tm = _models(_flags())
    jparams, jopt, jstate = _jax_train_state(jm, 9)
    path = str(tmp_path / "model_7.npz")
    j_ck.save(path, {"params": jparams, "opt": jstate,
                     "step": jnp.asarray(7)})
    tp0 = tm.init_params(torch.Generator().manual_seed(0))
    adam = t_opt.ClipAdam(1e-3, 5.0)
    tp, ts = t_ck.load_train_state(path, tp0, adam.init(tp0))
    assert isinstance(ts["mu"]["dec"]["blocks"], list)
    jflat = {k: np.array(v) for k, v in j_ck._flatten(
        {"params": jparams, "opt": jstate}).items()}
    ours = t_ck.flatten({"params": tp, "opt": ts})
    assert any("['blocks'][1]" in t_ck.state_keystr(p) for p in ours)
    for p, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), jflat[t_ck.state_keystr(p)])
    assert int(ts["count"]) == 2

    adam.step(tp, jax.tree.map(lambda a: 0.5 * torch.ones_like(a), tp), ts)
    back_path = str(tmp_path / "model_8.npz")
    t_ck.save(back_path, tp, ts, step=8)
    template = {"params": jm.init_params(jax.random.PRNGKey(0)),
                "opt": jopt.init(jparams)}
    back = j_ck._flatten(j_ck.load(back_path, template, strict=False))
    for p, v in t_ck.flatten({"params": tp, "opt": ts}).items():
        np.testing.assert_array_equal(np.asarray(back[t_ck.state_keystr(p)]),
                                      v.numpy())


def test_tiny_transformer_cli_run(tmp_path, one_thread):
    """main --tiny 1 --phase 1 with the transformer flags, blocks'
    dropout on, --device cpu: checkpoints with their Adam moments under
    the list-index keys, samples, result.json with finite losses."""
    argv = ["--tiny", "1", "--phase", "1", "--dataset", "synthetic",
            "--device", "cpu", "--runname", "t",
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data")] + _flags(0.1)
    argv.remove("--max_seq_len")
    argv.remove(str(TLEN))
    cfg = t_main.main(argv)
    run = cfg.savepath
    with np.load(os.path.join(run, "model_100.npz")) as data:
        assert int(data["['opt'][1][0].count"]) == 101
        nu = data["['opt'][1][0].nu['enc']['blocks'][1]['ff1']['w']"]
        assert nu.shape == (D_MODEL, 32) and np.abs(nu).sum() > 0
    with open(os.path.join(run, "vae_gen.txt")) as fh:
        assert len(fh.read().splitlines()) == cfg.evals.sample_size
    with open(os.path.join(run, "result.json")) as fh:
        rows = json.load(fh)
    logged = [r for r in rows if "train_L_vae" in r]
    assert logged and all(math.isfinite(r[k]) for r in logged for k in r)
    assert [r["it"] for r in rows if "hld_cov_frob" in r] == [25, 50, 75, 100]


@pytest.mark.parametrize("families", [("transformer", "gru"),
                                      ("gru", "transformer")])
def test_mixed_families_still_refuse_to_train(families, tmp_path,
                                              one_thread):
    """The mixed families used to refuse to train; they train now (their
    parity with the JAX package: tests/test_torch_mixed.py). A short
    phase-1 CLI run of each at a small width: finite logged losses and a
    checkpoint holding both families' parts."""
    argv = ["--phase", "1", "--dataset", "synthetic", "--device", "cpu",
            "--runname", "mixed",
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data"),
            "--model.E_args.E_class", families[0],
            "--model.G_args.G_class", families[1],
            "--model.z_dim", "6", "--model.emb_dim", "10",
            "--model.E_args.h_dim", "5", "--max_seq_len", "10",
            "--vae.batch_size", "4", "--vae.n_iter", "4",
            "--vae.cheaplog_every", "2", "--vae.expsvlog_every", "4",
            "--evals.sample_size", "4"]
    for part in ("E_args", "G_args"):
        for k, v in (("d_model", D_MODEL), ("d_ff", 32), ("n_heads", 2),
                     ("n_layers", 1)):
            argv += [f"--model.{part}.T_args.{k}", str(v)]
    cfg = t_main.main(argv)
    with open(os.path.join(cfg.savepath, "result.json")) as fh:
        rows = [r for r in json.load(fh) if "train_L_vae" in r]
    assert [r["it"] for r in rows] == [0, 2, 4]
    assert all(math.isfinite(r[k]) for r in rows for k in r)
    with np.load(os.path.join(cfg.savepath, "model_4.npz")) as data:
        keys = data.files
    tfm_part = "enc" if families[0] == "transformer" else "dec"
    gru_part = "dec" if tfm_part == "enc" else "enc"
    assert any(k.startswith(f"['params']['{tfm_part}']['blocks'][0]")
               for k in keys)
    assert any(k.startswith(f"['params']['{gru_part}']['gru") for k in keys)
