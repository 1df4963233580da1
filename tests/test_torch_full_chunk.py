"""The port's phase-2 chunk (``--hw.unroll`` in phase 2, ``FullChunk``)
and ``--hw.profile_dir`` on the CPU, at the sizes of test_torch_phase2.py
(V 13, T 7, B 4; the transformer at test_torch_phase2_tfm.py's width):

* ``aligned_unroll`` of phase 2's cadences against the JAX package's;
* a chunk of 3 iterations bit for bit equal to 3 ``FullStep`` calls from
  the same params, batches and draws (params, the three Adam states with
  opt_G's two steps an iteration, the last metrics), under schedules whose
  beta and softmax temperature change at every iteration, for the GRU and
  the transformer, in the none_softmax and categorical_softmax modes; the
  draws written into buffers (``out=``) equal to fresh ones;
* the same 3 iterations with the JAX draws of ``fold_in(key, it)``
  injected against JAX ``make_full_scan(unroll=3)``;
* ``main --phase 2`` at ``--hw.unroll 5`` and 1: the same checkpoints bit
  for bit and the same result.json rows;
* ``main --phase 1 --hw.profile_dir``: a torch.profiler trace of the
  loop's boundaries 3-4 (steps, or chunks at ``--hw.unroll 5``) and no
  others, holding the step's ranges and the loop's spans; phase 2
  accepts the flag and writes no trace.

Tolerances against the JAX package, as test_torch_phase2.py holds a
step: the last metrics rtol 1e-5, and each sub-loss of the last iteration
at the JAX params of its own sub-stage rtol 1e-5 (Adam turns last-bit
differences of the params into steps of up to 2 lr, so the port's own
params are not held to the JAX package's)."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import train_full as j_full
from controlled_peptide_generation_tpu.train.train_vae import (
    aligned_unroll as j_aligned_unroll)

from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_full as t_full
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import runtime

from test_torch_phase2 import (B, LOSS_TOL, TLEN, _jax_parts, _models, _t,
                               _to_port, _tokens, jax_full_draws)
from test_torch_phase2_tfm import _flags as tfm_flags

UNROLL, IT0 = 3, 1
# beta 1.0 -> 2.0 and the softmax temperature 1.0 -> 0.7 over iterations
# 0-3: every iteration of the chunk (1, 2, 3) has its own of each
SCHED = ["--full.beta.start.iter", "0", "--full.beta.end.iter", "3",
         "--full.beta.start.val", "1.0", "--full.beta.end.val", "2.0",
         "--full.softmax_temp.start.iter", "0",
         "--full.softmax_temp.end.iter", "3",
         "--full.softmax_temp.start.val", "1.0",
         "--full.softmax_temp.end.val", "0.7"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(seed):
    """texts, labelled texts [UNROLL, B, T] and labels [UNROLL, B]."""
    texts = np.stack([_tokens(seed + i) for i in range(UNROLL)])
    lab_texts = np.stack([_tokens(seed + 10 + i) for i in range(UNROLL)])
    lab_ys = np.random.default_rng(seed).integers(
        0, 2, (UNROLL, B)).astype(np.int32)
    return texts, lab_texts, lab_ys


def test_aligned_unroll_of_phase2_cadences_matches_jax():
    # phase 2's defaults (50 / 2,000), the tiny run's and the smoke's
    for cadences in ((50, 2000), (5, 10), (25, 50), (10, 20), (7, 15),
                     (2, 2), (1, 4)):
        for unroll in (1, 3, 5, 10, 25, 49, 50, 64):
            assert t_tv.aligned_unroll(unroll, *cadences) == \
                j_aligned_unroll(unroll, *cadences), (unroll, cadences)
    assert t_tv.aligned_unroll(50, 50, 2000) == 50


@pytest.mark.parametrize("family,mode", [
    ("gru", "none_softmax"), ("gru", "categorical_softmax"),
    ("transformer", "none_softmax"), ("transformer", "categorical_softmax")])
def test_chunk_equals_the_steps_bitwise(family, mode, one_thread):
    argv = SCHED + ["--full.G_soft_sample_kwargs.sample_mode", mode]
    if family == "transformer":
        argv += tfm_flags(0.1)
    _, tcfg, _, tm = _models(argv)
    rf = L_rf(tm)
    runs = []
    for chunked in (True, False):
        params = tm.init_params(torch.Generator().manual_seed(40))
        params["clf"] = tm.init_classifier(torch.Generator().manual_seed(41))
        for leaf in t_ck.flatten(params).values():
            leaf.requires_grad_(True)
        chunk = t_full.FullChunk(tm, tcfg.full, tcfg.losses, rf, UNROLL,
                                 seed=42)
        states = chunk.step.init(params)
        texts, lab_texts, lab_ys = _batches(43)
        if chunked:
            metrics = chunk(params, states, texts, lab_texts, lab_ys, IT0)
        else:
            for i in range(UNROLL):
                it = IT0 + i
                draws = t_full.draw_full_step(
                    tm, runtime.generator("cpu", 42, t_full._STEP_STREAM,
                                          it),
                    B, B, TLEN, "cpu", tcfg.full)
                metrics = chunk.step(params, states, _t(texts[i]),
                                     _t(lab_texts[i]), _t(lab_ys[i]), it,
                                     draws)
        runs.append((t_ck.flatten({"params": params, "opt": states}),
                     metrics))
    (state_c, met_c), (state_s, met_s) = runs
    assert state_c.keys() == state_s.keys()
    for k in state_c:
        assert torch.equal(state_c[k], state_s[k]), t_ck.keystr(k)
    assert met_c.keys() == met_s.keys()
    for k in met_c:
        assert torch.equal(met_c[k], met_s[k]), k
    assert [int(state_c["opt", n, "count"]) for n in "EGC"] == [
        UNROLL, 2 * UNROLL, UNROLL]
    assert float(met_c["beta"]) == np.float32(2.0)
    assert float(met_c["softmax_temp"]) == np.float32(0.7)
    # the draws written into buffers are the fresh draws' bits
    gen = lambda: runtime.generator("cpu", 42, 6, 9)  # noqa: E731
    fresh = t_full.draw_full_step(tm, gen(), B, B, TLEN, "cpu", tcfg.full)
    bufs = t_ck.unflatten({k: torch.zeros_like(v) for k, v in
                           t_ck.flatten(fresh).items()})
    again = t_full.draw_full_step(tm, gen(), B, B, TLEN, "cpu", tcfg.full,
                                  out=bufs)
    for k, v in t_ck.flatten(fresh).items():
        assert torch.equal(v, t_ck.flatten(bufs)[k]), k
        assert t_ck.flatten(again)[k].data_ptr() == \
            t_ck.flatten(bufs)[k].data_ptr(), k


def L_rf(tm):
    from controlled_peptide_generation_tpu_torch.ops import losses
    return losses.init_rf_basis(torch.Generator().manual_seed(44), tm.z_dim,
                                16, "cpu")


def _jax_iterations(P, params, key, texts, lab_texts, lab_ys, scheds):
    """The JAX one_iter by hand, iteration by iteration (each gradient
    jitted once): the params at the start of each sub-stage (the VAE, the
    attribute and the classifier update) of the last iteration."""
    grads = (jax.jit(jax.grad(P["vae_loss"], has_aux=True)),
             jax.jit(jax.grad(P["g_attr_loss"], has_aux=True),
                     static_argnums=2),
             jax.jit(jax.grad(P["c_loss"], has_aux=True)))
    oE, oG, oC = (P[o].init(params) for o in ("opt_E", "opt_G", "opt_C"))
    for i, (beta, temp) in enumerate(scheds):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, IT0 + i), 3)
        stages = [params]
        g, _ = grads[0](params, k1, jnp.asarray(texts[i]), beta)
        upd, oE = P["opt_E"].update(P["masked"](g, ("emb", "enc", "flow")),
                                    oE, params)
        params = optax.apply_updates(params, upd)
        upd, oG = P["opt_G"].update(P["masked"](g, ("dec",)), oG, params)
        params = optax.apply_updates(params, upd)
        stages.append(params)
        g, _ = grads[1](params, k2, texts.shape[1], temp)
        upd, oG = P["opt_G"].update(P["masked"](g, ("dec",)), oG, params)
        params = optax.apply_updates(params, upd)
        stages.append(params)
        g, _ = grads[2](params, k3, jnp.asarray(lab_texts[i]),
                        jnp.asarray(lab_ys[i]), temp)
        upd, oC = P["opt_C"].update(P["masked"](g, ("clf",)), oC, params)
        params = optax.apply_updates(params, upd)
    return stages


def test_chunk_matches_jax_full_scan(one_thread):
    """3 iterations with the JAX draws injected against make_full_scan
    (GRU, categorical_softmax, mmd): the last metrics, and the port's
    three sub-losses of the last iteration at the JAX params of their
    sub-stages (the JAX iterations by hand, as the scan runs them)."""
    argv = SCHED + ["--full.G_soft_sample_kwargs.sample_mode",
                    "categorical_softmax", "--full.z_regu_loss", "mmd"]
    jcfg, tcfg, jm, tm = _models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(50))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(51), jm.z_dim, 16)
    key = jax.random.PRNGKey(52)
    texts, lab_texts, lab_ys = _batches(53)
    draws = [jax_full_draws(jm, jcfg, jax.random.fold_in(key, IT0 + i), B, B)
             for i in range(UNROLL)]
    scan, opts = j_full.make_full_scan(jm, jcfg.full, jcfg.losses, rf,
                                       UNROLL, donate=False)
    jmet = scan(jparams, *(o.init(jparams) for o in opts), key,
                jnp.asarray(texts), jnp.asarray(lab_texts),
                jnp.asarray(lab_ys), jnp.asarray(IT0, jnp.int32))[4]

    tparams = _to_port(jparams)
    chunk = t_full.FullChunk(tm, tcfg.full, tcfg.losses,
                             tuple(_t(a) for a in rf), UNROLL)
    states = chunk.step.init(tparams)
    tmet = chunk(tparams, states, texts, lab_texts, lab_ys, IT0,
                 draws=draws)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)

    scheds = [chunk.step.schedule(IT0 + i) for i in range(UNROLL)]
    stages = _jax_iterations(_jax_parts(jm, jcfg, rf), jparams, key, texts,
                             lab_texts, lab_ys, scheds)
    vae, attr, clf = t_full.make_full_losses(
        tm, tcfg.full, tcfg.losses.wae_mmd, tuple(_t(a) for a in rf))
    last = UNROLL - 1
    beta, temp = scheds[last]
    d = draws[last]
    calls = (lambda p: vae(p, _t(texts[last]), beta, d["vae"]),
             lambda p: attr(p, temp, d["attr"]),
             lambda p: clf(p, _t(lab_texts[last]), _t(lab_ys[last]), temp,
                           d["clf"]))
    for jp, fn in zip(stages, calls):
        _, met = fn(_to_port(jp))
        for k, v in met.items():
            np.testing.assert_allclose(v.item(), float(jmet[k]),
                                       err_msg=k, **LOSS_TOL)


def _cli(tmp_path, name, phase, extra=()):
    argv = ["--dataset", "synthetic", "--device", "cpu", "--runname", name,
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data"),
            "--model.z_dim", "6", "--model.emb_dim", "10",
            "--model.E_args.h_dim", "5", "--model.C_args.num_filters", "4",
            "--max_seq_len", "10", "--losses.wae_mmd.rf_dim", "16",
            "--vae.batch_size", "4", "--vae.n_iter", "2",
            "--vae.cheaplog_every", "1", "--vae.expsvlog_every", "2",
            "--full.s_iter", "0", "--full.n_iter", "10",
            "--full.cheaplog_every", "5", "--full.expsvlog_every", "10",
            "--evals.sample_size", "6",
            "--resume_result_json", "0", "--phase", str(phase)]
    return t_main.main(argv + list(extra))


def test_tiny_cli_phase2_unroll_matches_per_step(tmp_path, one_thread):
    """main --phase 2 from one phase-1 checkpoint, iterations 0-10, at
    --hw.unroll 5 (iteration 0 alone, then 1-5 and 6-10 as chunks between
    the log boundaries every 5 and 10 iterations) and at --hw.unroll 1:
    the same checkpoint bit for bit and the same logged rows (the rates
    aside). --hw.profile_dir is accepted and traces nothing in phase 2."""
    run1 = _cli(tmp_path, "p1", 1).savepath
    ckpt = os.path.join(run1, "model_2.npz")
    trace_dir = tmp_path / "trace2"
    runs = {u: _cli(tmp_path, f"u{u}", 2, [
        "--loadpath", ckpt, "--hw.unroll", str(u),
        "--hw.profile_dir", str(trace_dir)]).savepath for u in (5, 1)}
    assert not glob.glob(str(trace_dir / "*"))
    with np.load(os.path.join(runs[5], "model_10.npz")) as a, \
            np.load(os.path.join(runs[1], "model_10.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    rows = {}
    for u, run in runs.items():
        with open(os.path.join(run, "result.json")) as fh:
            rows[u] = [{k: v for k, v in r.items() if "steps_per_sec" not in k}
                       for r in json.load(fh)]
    assert rows[5] == rows[1]
    assert [r["it"] for r in rows[5] if "full_L_vae" in r] == [0, 5, 10]


def _trace_names(trace_dir):
    """The names of the events of the one Chrome trace in ``trace_dir``."""
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return [e.get("name", "") for e in json.load(fh)["traceEvents"]]


def test_phase1_profile_dir_writes_a_trace(tmp_path, one_thread):
    """main --phase 1 --hw.profile_dir, every step eager (steps 0-7): one
    Chrome trace in the directory holding steps 3-4 alone, with the train
    step's ranges and the loop's spans."""
    trace_dir = tmp_path / "trace"
    _cli(tmp_path, "prof", 1, ["--hw.profile_dir", str(trace_dir),
                               "--vae.n_iter", "7"])
    names = _trace_names(trace_dir)
    assert {n for n in names if n.startswith("ProfilerStep#")} == {
        "ProfilerStep#3", "ProfilerStep#4"}
    assert {"forward", "backward", "optimizer", "train.loader",
            "train.boundary", "train.sample"} <= set(names)
    assert names.count("forward") == 2


def test_profile_dir_window_of_chunks(tmp_path, one_thread):
    """At --hw.unroll 5 the loop's boundaries are step 0 and 5-step
    chunks: the trace holds boundaries 3-4, two chunks (steps 11-20),
    and no others: 10 steps' ranges, two loader and boundary spans."""
    trace_dir = tmp_path / "trace"
    _cli(tmp_path, "profc", 1, ["--hw.profile_dir", str(trace_dir),
                                "--vae.n_iter", "40", "--hw.unroll", "5",
                                "--vae.cheaplog_every", "5",
                                "--vae.expsvlog_every", "20"])
    names = _trace_names(trace_dir)
    assert {n for n in names if n.startswith("ProfilerStep#")} == {
        "ProfilerStep#3", "ProfilerStep#4"}
    assert names.count("forward") == names.count("optimizer") == 10
    assert names.count("train.loader") == names.count("train.boundary") == 2
    assert names.count("train.save") == 1     # the boundary at step 20
