"""ZeRO-1 of the port (``parallel/zero.py``) on the CPU: two gloo ranks
spawned by the port's helper run 3 steps of the ZeRO-1 step and of the
plain DP step on the JAX package's draws of the global batch, once for
the module. Held against

* the JAX package's ``make_zero_train_step`` on a 2-device mesh: params
  within rtol 2e-4 / atol 2e-5, L_vae within 1e-4;
* the port's plain DP step on the same inputs (the trajectory is plain
  DP's up to the order of the norm's sum): params and the moments
  gathered in full within rtol 1e-5 / atol 1e-6, the metrics within 1e-5;
* the checkpoint the ZeRO run's rank 0 wrote (its moments gathered in
  full): it loads into the JAX package's train state and into the port's
  one-device per-leaf Adam, equal to the gathered moments bit for bit;
* ``main.main --hw.dp 2 --hw.zero 1`` against ``--hw.dp 1``, and a ZeRO
  run resumed from its checkpoint.

And the segment layout: ceil(n / world) entries a rank, the last segment
padded with at most world - 1 zeros."""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
from controlled_peptide_generation_tpu_torch.parallel.zero import ZeroAdam
from controlled_peptide_generation_tpu_torch.tools import dp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import opt as t_opt

from test_torch_dp_train import SMALL, _cli_argv, _jax_params_flat
from test_torch_train import _jax_draws, _tokens

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
SAME_TOL = dict(rtol=1e-5, atol=1e-6)
V, TLEN, B, STEPS = 13, 7, 8, 3


def _jax_zero(jm, jcfg, jparams, rf, key, texts):
    mesh = jpar.get_mesh(2)
    step, _, init_state = jpar.make_zero_train_step(
        jm, jcfg.vae, jcfg.losses, rf, mesh, donate=False)
    p, o = init_state(jparams)
    losses = []
    for it in range(STEPS):
        p, o, m = step(p, o, jax.random.fold_in(key, it),
                       jpar.shard_batch(mesh, jnp.asarray(texts[it])),
                       jnp.asarray(it, jnp.int32))
        losses.append(float(m["L_vae"]))
    return j_ck._flatten({"params": p}), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    jcfg, _, _ = JC.parse_and_finalize(SMALL)
    jm = j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(1), jm.z_dim,
                           jcfg.losses.wae_mmd.rf_dim)
    key = jax.random.PRNGKey(7)
    texts = np.stack([_tokens(70 + it, B) for it in range(STEPS)])
    steps = [(texts[it], {k: v.numpy() for k, v in _jax_draws(
        jm, jax.random.fold_in(key, it), texts[it]).items()})
        for it in range(STEPS)]
    base = {"kind": "train", "argv": SMALL, "V": V, "T": TLEN,
            "params": _jax_params_flat(jparams),
            "rf": [np.asarray(a) for a in rf], "steps": steps}
    ckpt = str(tmp / "zero_3.npz")
    cli = _cli_argv(tmp, "zero", 2) + ["--hw.zero", "1"]
    resume = _cli_argv(tmp, "zero_again", 2) + [
        "--hw.zero", "1", "--loadpath", str(tmp / "out" / "zero" /
                                            "model_20.npz")]
    cases = [dict(base, zero=True, save=ckpt), dict(base),
             {"kind": "main", "argv": cli}, {"kind": "main", "argv": resume}]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = str(tmp / "cases.pkl")
        with open(path, "wb") as fh:
            pickle.dump(cases, fh)
        pdist.spawn(dp_check.run, 2, path, str(tmp))
        got = []
        for r in range(2):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                got.append(pickle.load(fh))
        t_main.main(_cli_argv(tmp, "plain", 1))
    finally:
        torch.set_num_threads(n)
    want, losses = _jax_zero(jm, jcfg, jparams, rf, key, texts)
    return types.SimpleNamespace(
        tmp=tmp, jm=jm, jparams=jparams, ckpt=ckpt, want=want,
        losses=losses, zero=got[0][0], zero_other=got[1][0], dp=got[0][1])


def test_zero_matches_jax_make_zero_train_step(runs):
    got = runs.zero["params"]
    assert set(got) == {k for k in runs.want
                        if not k.startswith("['params']['clf']")}
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(runs.want[k]), err_msg=k,
                                   **PARAM_TOL)
        np.testing.assert_array_equal(v, runs.zero_other["params"][k])
    for m, loss in zip(runs.zero["metrics"], runs.losses):
        assert abs(m["L_vae"] - loss) < 1e-4


def test_zero_matches_plain_dp(runs):
    """Params, the metrics and the moments gathered in full: ZeRO-1 is
    plain DP up to the norm's order of summation."""
    for part in ("params", "opt"):
        want = runs.dp[part]
        assert set(runs.zero[part]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(runs.zero[part][k], v, err_msg=k,
                                       **SAME_TOL)
    for gm, wm in zip(runs.zero["metrics"], runs.dp["metrics"]):
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5, err_msg=k)


def test_zero_checkpoint_loads_into_jax_and_one_device_port(runs):
    """Rank 0's file holds the per-leaf Adam state gathered in full: the
    JAX package's train state loads it (the classifier keeps the
    template's values), and so does the port's one-device per-leaf Adam,
    each leaf equal to the ZeRO run's gathered moments."""
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
    template = {"params": runs.jparams, "opt": opt.init(runs.jparams)}
    back = j_ck._flatten(j_ck.load(runs.ckpt, template, strict=False))
    assert int(back["['opt'][1][0].count"]) == STEPS
    for k, v in runs.zero["params"].items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    for k, v in runs.zero["opt"].items():
        if k == "['count']":
            continue
        name, rest = k[2:4], k[6:]
        jk = f"['opt'][1][0].{name}{rest}"
        np.testing.assert_array_equal(np.asarray(back[jk]), v, err_msg=jk)

    cfg, _, _ = TC.parse_and_finalize(SMALL)
    tm = t_build(cfg.model, n_vocab=V, max_seq_len=TLEN)
    tp0 = tm.init_params(torch.Generator().manual_seed(0))
    tp, ts = t_ck.load_train_state(runs.ckpt, tp0,
                                   t_opt.ClipAdam(1e-3, 5.0).init(tp0))
    ours = {t_ck.keystr(p): v.numpy() for p, v in t_ck.flatten(ts).items()}
    assert ours.keys() == runs.zero["opt"].keys()
    for k, v in runs.zero["opt"].items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_cli_zero_matches_dp1_and_resumes(runs):
    """main.main --hw.dp 2 --hw.zero 1 (every step eager, as in JAX)
    against --hw.dp 1: model_20.npz within rtol 2e-4 / atol 2e-5; a ZeRO
    run resumed from it continues the Adam count."""
    out = runs.tmp / "out"
    a = np.load(out / "zero" / "model_20.npz")
    b = np.load(out / "plain" / "model_20.npz")
    assert set(a.files) == set(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **PARAM_TOL)
    again = np.load(out / "zero_again" / "model_20.npz")
    assert int(again["['opt'][1][0].count"]) == 21 + 21


@pytest.mark.parametrize("world,n", [(2, 7), (2, 8), (3, 7), (4, 5)])
def test_zero_segments_and_padding(world, n):
    """ceil(n / world) entries a rank; the padding is world * segment - n
    < world zeros at the end of the last segments; from_full and
    full_state's unravel are inverse."""
    params = {"a": torch.arange(n - 2, dtype=torch.float32),
              "b": torch.ones(2)}
    for rank in range(world):
        opt = ZeroAdam(1e-3, 5.0, types.SimpleNamespace(world=world,
                                                         rank=rank))
        order, sizes, seg, pad = opt.layout(params)
        assert order == [("a",), ("b",)] and sizes == [n - 2, 2]
        assert seg == -(-n // world) and 0 <= pad == seg * world - n < world
        full = {"count": torch.tensor(3, dtype=torch.int32),
                "mu": {"a": torch.arange(n - 2.0), "b": torch.full((2,), 9.0)},
                "nu": {"a": torch.zeros(n - 2), "b": torch.ones(2)}}
        state = opt.from_full(params, full)
        vec = np.concatenate([np.arange(n - 2.0), [9.0, 9.0],
                              np.zeros(pad)])
        np.testing.assert_array_equal(state["m"].numpy(),
                                      vec[rank * seg:(rank + 1) * seg])
        assert state["v"].shape == (seg,) and int(state["count"]) == 3
