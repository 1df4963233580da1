"""Tensor, pipeline and data parallelism composed: one spawn of four gloo
ranks (``parallel.dist.spawn``) runs ``tools/mp_check.py``'s cases on
three meshes of the same ranks, held against

* the JAX package's 3D step (``get_mesh_3d(1, 2, 2)``, ``make_pp_model``
  and ``make_tp_train_step``): params and Adam moments after each of 3
  phase-1 steps on a (1, 2, 2) mesh (two stages, two model ranks each);
* the port's one-device step on the same inputs: 3 steps on (2, 1, 2)
  (data x model, the blocks' dropout on, each data rank its rows) and on
  (2, 2, 1) (data x pipe), and one phase-2 iteration on (1, 2, 2), its
  three sub-losses' gradients first;
* ``main.main --phase -1`` at ``--hw.tp 2 --hw.pp 2`` (every step eager,
  as under TP) and at ``--hw.dp 2 --hw.pp 2`` (chunks of 5 steps, eager on
  the CPU), each against the one-rank run of the same flags.

Tolerances: ``mp_helpers`` (atol 5e-5 / rtol 1e-5)."""

import json
import types

import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch.tools import mp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_full as t_tf
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import runtime

import mp_helpers as H

# (mesh, p_dropout) of the port-only phase-1 cases
PORT_MESHES = {"data x model": ((2, 1, 2), 0.1),
               "data x pipe": ((2, 2, 1), 0.0)}


def _port_case(argv, mesh, seed, phase=1):
    """A case of the port's own seeded params and draws."""
    _, tcfg, _, tm = H.models(argv)
    params = tm.init_params(runtime.generator("cpu", seed))
    if phase == 2:
        params["clf"] = tm.init_classifier(runtime.generator("cpu", seed + 1))
    rf = t_tv.L.init_rf_basis(runtime.generator("cpu", seed + 2), H.Z, 16)
    steps = []
    for it in range(H.STEPS if phase == 1 else 1):
        gen = runtime.generator("cpu", seed + 3, it)
        if phase == 1:
            steps.append((H.tokens(seed + it), H.numpy_tree(
                t_tv.draw_step(tm, gen, H.B, H.TLEN, "cpu"))))
        else:
            steps.append((H.tokens(seed), H.tokens(seed + 1),
                          np.array([0, 1, 1, 0], np.int32),
                          H.numpy_tree(t_tf.draw_full_step(
                              tm, gen, H.B, H.B, H.TLEN, "cpu", tcfg.full))))
    return {"kind": "train" if phase == 1 else "full", "argv": argv,
            "V": H.V, "T": H.TLEN, "mesh": mesh,
            "params": {t_ck.keystr(("params",) + p): v.numpy()
                       for p, v in t_ck.flatten(params).items()},
            "rf": [a.numpy() for a in rf], "steps": steps}


# the layouts of the main.main runs on four ranks
CLI = {"tp2 pp2": ["--hw.tp", "2", "--hw.pp", "2"],
       "dp2 pp2": ["--hw.dp", "2", "--hw.pp", "2"]}


def _cli_argv(tmp, name, layout=()):
    return H.flags() + list(layout) + [
        "--phase", "-1", "--dataset", "synthetic", "--device", "cpu",
        "--savepath_toplevel", str(tmp / "out"), "--tb_toplevel",
        str(tmp / "tb"), "--datapath", str(tmp / "data"), "--runname", name,
        "--vae.n_iter", "10", "--vae.batch_size", "8",
        "--vae.cheaplog_every", "5", "--vae.expsvlog_every", "10",
        "--full.n_iter", "4", "--full.cheaplog_every", "2",
        "--full.expsvlog_every", "4", "--evals.sample_size", "4",
        "--resume_result_json", "0", "--hw.unroll", "5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp3d")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax3d, want3d = H.jax_train(H.flags(), "3d")
        port = {name: _port_case(H.flags(p_dropout=p), mesh, 50 + 10 * i)
                for i, (name, (mesh, p)) in enumerate(PORT_MESHES.items())}
        full = _port_case(H.flags(phase=2), (1, 2, 2), 80, phase=2)
        got = H.spawn(tmp, 4, [jax3d, *port.values(), full] + [
            {"kind": "main", "argv": _cli_argv(tmp, name.replace(" ", "_"),
                                               layout)}
            for name, layout in CLI.items()])
        one = {name: mp_check.train_case(c) for name, c in port.items()}
        one["full"] = mp_check.full_case(full)
        t_main.main(_cli_argv(tmp, "one"))
    finally:
        torch.set_num_threads(n)
    names = ["3d", *port, "full"]
    return types.SimpleNamespace(
        tmp=tmp, want3d=want3d, one=one,
        got=[{nm: g[i] for i, nm in enumerate(names)} for g in got])


def test_3d_steps_match_jax_get_mesh_3d(runs):
    """(1, 2, 2): the 3 steps against JAX's make_tp_train_step on its
    make_pp_model on get_mesh_3d(1, 2, 2); all four ranks hold the same
    full state."""
    got = runs.got[0]["3d"]
    for s, (g, w) in enumerate(zip(got, runs.want3d)):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])
    for r in range(1, 4):
        for k, v in got[-1]["state"].items():
            np.testing.assert_array_equal(
                v, runs.got[r]["3d"][-1]["state"][k], err_msg=k)


@pytest.mark.parametrize("name", list(PORT_MESHES))
def test_dp_composed_layouts_match_one_device(runs, name):
    """Data parallelism over model or pipe ranks: 3 steps against the
    port's one-device step on the global batch."""
    for s, (g, w) in enumerate(zip(runs.got[0][name], runs.one[name])):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])


def test_3d_phase2_iteration_matches_one_device(runs):
    """(1, 2, 2), phase 2: each sub-loss's group gradients at the
    starting params (the ranks' parts gathered) within TOL of the
    one-device gradients, then the params and metrics after the
    iteration."""
    got, want = runs.got[0]["full"], runs.one["full"]
    assert set(got["grads"]) == set(want["grads"])
    for g, tree in want["grads"].items():
        for k, v in tree.items():
            np.testing.assert_allclose(got["grads"][g][k], v,
                                       err_msg=f"{g} {k}", **H.TOL)
    H.assert_state(got["steps"][0]["state"], want["steps"][0]["state"], 2,
                   skip=())
    H.assert_metrics(got["steps"][0]["metrics"], want["steps"][0]["metrics"])


@pytest.mark.parametrize("layout", list(CLI))
def test_cli_on_four_ranks_matches_one_rank(runs, layout):
    """main.main --phase -1 on four ranks against one rank: both phases'
    checkpoints, the logged losses (the heldout eval's too), the
    samples."""
    out = runs.tmp / "out"
    run = layout.replace(" ", "_")
    for name in ("model_10.npz", "model_12.npz"):
        a, b = (np.load(out / r / name) for r in (run, "one"))
        H.assert_state({k: a[k] for k in a.files},
                       {k: b[k] for k in b.files}, 21, skip=())
    rows = []
    for r in (run, "one"):
        with open(out / r / "result.json") as fh:
            rows.append(json.load(fh))
    assert len(rows[0]) == len(rows[1]) > 0
    assert any("hld_recon" in r for r in rows[1])
    for got, want in zip(*rows):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if "_L_" in k or k.startswith("hld_"):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    for name in ("vae_gen.txt", "full_gen.txt", "full_samez.txt"):
        assert (out / run / name).read_text() == (
            out / "one" / name).read_text()
