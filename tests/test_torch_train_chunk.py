"""The port's multi-step train chunk (``--hw.unroll``) against the JAX
package on the CPU, at the small sizes of test_torch_train.py and
test_torch_train_tfm.py: a chunk of 3 steps against JAX
``make_train_scan(unroll=3)`` from the same params, texts, key and it0,
the JAX draws of ``fold_in(key, it)`` injected (GRU with either Adam, and
the transformer with its blocks' dropout); ``aligned_unroll`` against
JAX's; and tiny CLI runs at --hw.unroll 5 and 1 giving the same
checkpoints bit for bit and the same result.json rows, recording no span
while the loop's counters count the chunks; with spans on, the loop's
spans at their cadences, nested in its boundaries.

Tolerances: the last step's metrics rtol 1e-5; params and Adam moments
rtol 1e-5 / atol 1e-6, as test_torch_train.py holds the optimizer (fp32
sums in other orders)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train import opt as j_opt
from controlled_peptide_generation_tpu.train.train_vae import (
    aligned_unroll as j_aligned_unroll, make_train_scan as j_make_train_scan)

from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import tracing

import test_torch_train as gru_t
import test_torch_train_tfm as tfm_t

LOSS_TOL = dict(rtol=1e-5, atol=0)
TOL = dict(rtol=1e-5, atol=1e-6)
UNROLL, IT0 = 3, 1
# beta ramps over the chunk's steps: start 1 at it 0, end 2 at it 2
SCHED = ["--vae.n_iter", "10", "--vae.beta.end.val", "2.0"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_moments(jparams, jstate, flat, tparams):
    """{'count', 'm'/'mu', 'v'/'nu'} of the JAX state over the port's
    leaves: the optax moments by key path, the flat vectors cut at the
    port's leaves in ravel order."""
    if not flat:
        adam = jstate[1][0]
        return int(adam.count), {
            name: {t_ck.keystr(p): np.asarray(leaf) for p, leaf in
                   t_ck.flatten(_to_paths(getattr(adam, name))).items()}
            for name in ("mu", "nu")}
    _, unravel = ravel_pytree(jparams)
    out = {}
    for name in ("m", "v"):
        tree = j_ck._flatten(unravel(getattr(jstate, name)))
        out[name] = np.concatenate([np.asarray(tree[t_ck.keystr(p)]).reshape(
            -1) for p in t_ck.ravel_order(tparams)])
    return int(jstate.count), out


def _key_bias(path, shape, n_heads):
    """True at the entries of a transformer block's qkv bias that bias the
    keys (the fused projection is head-major: [heads, q k v, dh])."""
    mask = np.zeros(shape, bool)
    if path[-2:] == ("qkv", "b"):
        mask.reshape(n_heads, 3, -1)[:, 1] = True
    return mask


def _to_paths(jtree):
    """A JAX params-shaped tree (dicts, lists) without the classifier."""
    return {k: v for k, v in jtree.items() if k != "clf"}


@pytest.mark.parametrize("family,flat", [("gru", False), ("gru", True),
                                         ("transformer", False)])
def test_chunk_matches_jax_train_scan(family, flat, one_thread):
    if family == "gru":
        jcfg, tcfg, jm, tm = gru_t._models(SCHED)
        draws_of = lambda k, text: gru_t._jax_draws(tm, k, text)  # noqa
        tokens, to_port = gru_t._tokens, gru_t._to_port
        Z = 6
    else:
        jcfg, tcfg, jm, tm = tfm_t._models(tfm_t._flags(0.1) + SCHED)
        draws_of = lambda k, text: tfm_t._jax_draws(k, 0.1)  # noqa
        tokens, to_port = tfm_t._tokens, tfm_t._to_port
        Z = tfm_t.Z
    jparams = jm.init_params(jax.random.PRNGKey(4))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(5), Z, 16)
    key = jax.random.PRNGKey(6)
    texts = np.stack([tokens(7 + i) for i in range(UNROLL)])
    j_opt.set_flat_optimizer(flat)
    try:
        chunk, optimizer = j_make_train_scan(
            jm, jcfg.vae, jcfg.losses, rf, UNROLL, donate=False)
        jstate = optimizer.init(jparams)
        jp, jstate, jmet = chunk(jparams, jstate, key, jnp.asarray(texts),
                                 jnp.asarray(IT0, jnp.int32))
    finally:
        j_opt.set_flat_optimizer(None)

    tparams = to_port(jparams)
    for leaf in t_ck.flatten(tparams).values():
        leaf.requires_grad_(True)
    t_chunk = t_tv.make_train_chunk(
        tm, tcfg.vae, tcfg.losses,
        tuple(torch.from_numpy(np.array(a)) for a in rf), UNROLL, flat=flat)
    tstate = t_chunk.optimizer.init(tparams)
    draws = [draws_of(jax.random.fold_in(key, IT0 + i), texts[i])
             for i in range(UNROLL)]
    tmet = t_chunk(tparams, tstate, texts, IT0, draws=draws)

    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **LOSS_TOL)
    assert float(tmet["beta"]) == 2.0
    jflat = j_ck._flatten(jp)
    for p, v in t_ck.flatten(tparams).items():
        got, want = v.detach().numpy(), np.asarray(jflat[t_ck.keystr(p)])
        noise = _key_bias(p, got.shape,
                          tcfg.model.G_args.T_args.get("n_heads", 4))
        # the attention keys' bias: softmax ignores a shift shared by all
        # keys, so its gradient is rounding noise, which Adam scales to up
        # to lr a step in either package
        assert np.abs(got - want)[noise].max(initial=0) <= UNROLL * 1e-3
        np.testing.assert_allclose(got[~noise], want[~noise],
                                   err_msg=t_ck.keystr(p), **TOL)
    count, moments = _jax_moments(jp, jstate, flat, tparams)
    assert int(tstate["count"]) == count == UNROLL
    for name, want in moments.items():
        if flat:
            np.testing.assert_allclose(tstate[name].numpy(), want, **TOL)
            continue
        for p, v in t_ck.flatten(tstate[name]).items():
            np.testing.assert_allclose(v.numpy(), want[t_ck.keystr(p)],
                                       err_msg=t_ck.keystr(p), **TOL)


def test_chunk_refuses_a_resampled_rf_basis():
    _, tcfg, _, tm = gru_t._models()
    with pytest.raises(ValueError, match="fixed RF basis"):
        t_tv.make_train_chunk(tm, tcfg.vae, tcfg.losses, None, UNROLL)


def test_aligned_unroll_matches_jax():
    for unroll in (1, 2, 3, 5, 7, 10, 25, 49, 50, 64, 100, 500):
        for cadences in ((10, 25), (100, 150), (500, 20000), (25, 50),
                         (7, 7), (1, 1000), (96, 144)):
            assert t_tv.aligned_unroll(unroll, *cadences) == \
                j_aligned_unroll(unroll, *cadences), (unroll, cadences)
    assert t_tv.aligned_unroll(50, 100, 150) == 50
    assert t_tv.aligned_unroll(64, 500, 20000) == 50


def _tiny_run(tmp_path, name, unroll):
    argv = ["--tiny", "1", "--phase", "1", "--dataset", "synthetic",
            "--device", "cpu", "--runname", name,
            "--savepath_toplevel", str(tmp_path / "out"),
            "--tb_toplevel", str(tmp_path / "tb"),
            "--datapath", str(tmp_path / "data"), "--hw.unroll", str(unroll)]
    return t_main.main(argv).savepath


def test_tiny_cli_unroll_matches_per_step(tmp_path, one_thread):
    """--hw.unroll 5 (chunks of 5 between the log boundaries every 10 and
    25 iterations) and --hw.unroll 1 give the same checkpoints bit for bit
    and the same logged rows (the rates aside). With no profiler and
    spans not forced on, the loop records no span; its loader and
    boundary counters count the 20 chunks of the --hw.unroll 5 run."""
    tracing.clear()
    before = tracing.snapshot()
    runs = {u: _tiny_run(tmp_path, f"u{u}", u) for u in (5, 1)}
    after = tracing.snapshot()
    assert tracing.spans() == []
    for name in ("train.loader", "train.boundary"):
        assert after[name]["count"] - before.get(
            name, {"count": 0})["count"] == 20, name
    for it in (25, 50, 75, 100):
        with np.load(os.path.join(runs[5], f"model_{it}.npz")) as a, \
                np.load(os.path.join(runs[1], f"model_{it}.npz")) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), (it, k)
    rows = {}
    for u, run in runs.items():
        with open(os.path.join(run, "result.json")) as fh:
            rows[u] = [{k: v for k, v in r.items() if "steps_per_sec" not in k}
                       for r in json.load(fh)]
    assert rows[5] == rows[1]
    assert [r["it"] for r in rows[5] if "train_L_vae" in r] == sorted(
        set(range(0, 101, 10)) | {25, 75})


def test_tiny_cli_spans_follow_the_loop(tmp_path, one_thread):
    """With spans forced on, the tiny run at --hw.unroll 5 (step 0, then
    20 chunks of 5 steps; a sample every 10 and at each checkpoint, every
    25): a loader and a boundary span a chunk and step 0, each counted
    chunk's in the counters; train.sample and train.save at their
    cadences, each nested in the boundary of its step."""
    tracing.clear()
    before = tracing.snapshot()
    tracing.enable()
    try:
        _tiny_run(tmp_path, "spans", 5)
    finally:
        tracing.enable(False)
    after = tracing.snapshot()
    chunk_its = list(range(1, 100, 5))
    loader = [s.ids["it"] for s in tracing.spans("train.loader")]
    assert loader == [0] + chunk_its
    bounds = {s.ids["it"]: s for s in tracing.spans("train.boundary")}
    assert sorted(bounds) == [0] + [i + 4 for i in chunk_its]
    cheap = sorted(set(range(0, 101, 10)) | {25, 75})
    samples = tracing.spans("train.sample")
    assert [s.ids["it"] for s in samples] == cheap
    saves = tracing.spans("train.save")
    assert [s.ids["it"] for s in saves] == [25, 50, 75, 100]
    for s in samples + saves:
        b = bounds[s.ids["it"]]
        assert s.parent == b.id and b.start_ns <= s.start_ns <= s.end_ns \
            <= b.end_ns
    assert tracing.spans("train.fetch")
    for name in ("train.loader", "train.boundary"):
        d = after[name]["count"] - before.get(name, {"count": 0})["count"]
        assert d == len(chunk_its), name
