"""Phase-2 data parallelism of the port on the CPU: two gloo ranks spawned
by the port's helper run ``tools/dp_check.py``'s phase-2 iterations on
the JAX package's draws of the global batches, once for the module, and
are held against

* the JAX package's ``make_dp_full_step`` on a 2-device mesh: params after
  2 iterations within rtol 2e-4 / atol 2e-5 (the JAX DP test's bound),
  each iteration's losses within 1e-4;
* the port's one-device ``FullStep`` on the global batches: the VAE,
  attribute and classifier losses' group gradients at the same params
  within 1e-4 of each tensor's largest entry (as tests/test_torch_phase2.py
  holds them to JAX's), and the iterations' metrics within 1e-4;

for the default sampling modes under mmdrf, and for the full-kernel MMD
with the categorical soft mode (its Gumbel noise, [T, n, V], split on its
row axis); and a ``main.main --phase -1`` run at ``--hw.dp 2`` against
``--hw.dp 1``."""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
from controlled_peptide_generation_tpu_torch.tools import dp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

from test_torch_phase2 import (SMALL, TLEN, V, _models, _tokens,
                               jax_full_draws)

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL = 1e-4
GRAD_REL = 1e-4
B, ITERS = 8, 2
CASES = {"mmdrf": [],
         "mmd_categorical": ["--full.z_regu_loss", "mmd",
                             "--full.G_soft_sample_kwargs.sample_mode",
                             "categorical_softmax"]}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _case(name):
    """The JAX DP iterations of case ``name`` and the port case carrying
    their inputs."""
    argv = SMALL + CASES[name]
    jcfg, _, jm, _ = _models(CASES[name])
    jparams = jm.init_params(jax.random.PRNGKey(30))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(31), jm.z_dim, 16)
    mesh = jpar.get_mesh(2)
    step, opts, _ = jpar.make_dp_full_step(jm, jcfg.full, jcfg.losses, rf,
                                           mesh, donate=False)
    state = [jpar.replicate(mesh, jparams)] + [
        jpar.replicate(mesh, o.init(jparams)) for o in opts]
    key = jax.random.PRNGKey(32)
    steps, metrics = [], []
    for it in range(ITERS):
        text, lab_text = _tokens(40 + it, B), _tokens(50 + it, B)
        lab_y = np.random.default_rng(60 + it).integers(0, 2, B).astype(
            np.int32)
        k_it = jax.random.fold_in(key, it)
        *state, m = step(*state, k_it, *(jpar.shard_batch(mesh, jnp.asarray(
            a)) for a in (text, lab_text, lab_y)), jnp.asarray(it, jnp.int32))
        metrics.append({k: float(v) for k, v in m.items()})
        steps.append((text, lab_text, lab_y, _numpy(jax_full_draws(
            jm, jcfg, k_it, B, B))))
    case = {"kind": "full", "argv": argv, "V": V, "T": TLEN,
            "params": {k: np.asarray(v) for k, v in j_ck._flatten(
                {"params": jparams}).items()},
            "rf": [np.asarray(a) for a in rf], "steps": steps}
    return case, {"params": j_ck._flatten({"params": state[0]}),
                  "metrics": metrics}


def _cli_argv(tmp, name, dp):
    return SMALL[:6] + SMALL[8:12] + [
        "--phase", "-1", "--dataset", "synthetic", "--device", "cpu",
        "--max_seq_len", "25", "--savepath_toplevel", str(tmp / "out"),
        "--tb_toplevel", str(tmp / "tb"), "--datapath", str(tmp / "data"),
        "--runname", name, "--vae.n_iter", "10", "--full.n_iter", "10",
        "--vae.batch_size", "8", "--full.batch_size", "8",
        "--vae.cheaplog_every", "5", "--vae.expsvlog_every", "10",
        "--full.cheaplog_every", "5", "--full.expsvlog_every", "10",
        "--evals.sample_size", "4", "--resume_result_json", "0",
        "--hw.unroll", "5", "--hw.dp", str(dp)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_full")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, want, one = [], {}, {}
        for name in CASES:
            case, want[name] = _case(name)
            one[name] = dp_check.full_case(case)
            cases.append(case)
        cases.append({"kind": "main", "argv": _cli_argv(tmp, "dp2", 2)})
        path = str(tmp / "cases.pkl")
        with open(path, "wb") as fh:
            pickle.dump(cases, fh)
        pdist.spawn(dp_check.run, 2, path, str(tmp))
        got = []
        for r in range(2):
            with open(tmp / f"rank{r}.pkl", "rb") as fh:
                got.append(pickle.load(fh))
        t_main.main(_cli_argv(tmp, "dp1", 1))
    finally:
        torch.set_num_threads(n)
    return types.SimpleNamespace(
        tmp=tmp, want=want, one=one,
        got={nm: got[0][i] for i, nm in enumerate(CASES)},
        other={nm: got[1][i] for i, nm in enumerate(CASES)})


@pytest.mark.parametrize("name", list(CASES))
def test_dp_iterations_match_jax_dp_full_step(runs, name):
    got, want = runs.got[name], runs.want[name]
    assert set(got["params"]) == set(want["params"])
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, np.asarray(want["params"][k]),
                                   err_msg=k, **PARAM_TOL)
        np.testing.assert_array_equal(v, runs.other[name]["params"][k])
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert set(gm) == set(wm)
        for k in ("L_vae", "L_attr_c", "L_attr_z", "L_clf_sup",
                  "L_clf_unsup", "clf_entropy"):
            assert abs(gm[k] - wm[k]) < LOSS_TOL * max(1.0, abs(wm[k])), k


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("stage", ["vae/E", "vae/G", "attr/G", "clf/C"])
def test_dp_group_grads_match_the_one_device_step(runs, name, stage):
    """Each sub-loss's group gradients at the starting params, averaged
    over the two ranks, against the one-device FullStep's on the global
    batches."""
    got, want = runs.got[name]["grads"][stage], runs.one[name]["grads"][stage]
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max(initial=0.0)), 1e-30)
        err = float(np.abs(got[k] - w).max(initial=0.0))
        assert err <= GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_metrics_match_the_one_device_step(runs, name):
    for gm, wm in zip(runs.got[name]["metrics"], runs.one[name]["metrics"]):
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_TOL,
                                       atol=1e-6, err_msg=k)


def test_cli_phase_both_dp2_matches_dp1(runs):
    """main.main --phase -1 at --hw.dp 2 (two gloo ranks, chunks of 5
    iterations in both phases) against --hw.dp 1: the last phase-2
    checkpoint (params, the classifier's included) and the written
    artifacts."""
    out = runs.tmp / "out"
    last = t_ck.latest_step(str(out / "dp1"))
    assert last == t_ck.latest_step(str(out / "dp2")) and last > 10
    a = np.load(out / "dp2" / f"model_{last}.npz")
    b = np.load(out / "dp1" / f"model_{last}.npz")
    assert set(a.files) == set(b.files)
    assert any(k.startswith("['params']['clf']") for k in a.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **PARAM_TOL)
    for name in ("full_gen.txt", "vae_gen.txt", "result.json"):
        assert os.path.exists(out / "dp2" / name)
