"""Pipeline parallelism of the port on the CPU: two gloo ranks spawned by
``parallel.dist.spawn`` run ``tools/mp_check.py``'s cases once for the
module (a (1, 2, 1) mesh: two stages), held against

* the JAX package's ``make_blocks_apply`` on a 2-stage pipe mesh: the
  schedule's output and its gradients (the input's and every block
  leaf's) for n_micro 1 and 2 at batch 4, and at batch 6 with n_micro 4
  (the gcd rule: 2 microbatches);
* its ``make_pp_model`` step: params and Adam moments after each of 3
  phase-1 steps (one block a stage; the schedule above runs two);
* the port's one-device step: the mixed family (GRU encoder) over 3
  steps.

The trainers under ``--hw.pp`` (their chunks too) run in
``tests/test_torch_tp3d.py``'s ``main.main`` cases and on the card
(``chip_smoke.py`` ``[12p]``, ``[12m]``).

And the errors where JAX asserts (depth not divisible by the stages,
block dropout on). Tolerances: ``mp_helpers`` (atol 5e-5 / rtol 1e-5)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu.parallel import pp as j_pp

from controlled_peptide_generation_tpu_torch.parallel import pp as t_pp
from controlled_peptide_generation_tpu_torch.tools import mp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import runtime

import mp_helpers as H

# (batch, n_micro of each schedule) of the blocks cases
BLOCKS = ((4, (1, 2)), (6, (4,)))


def _jax_blocks(jblocks, B, n_micros, seed):
    """JAX's schedule on a 2-stage pipe mesh: y and the gradients of
    sum(y * cot) for each n_micro, and the port's case of the inputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H.TLEN, 16)).astype(np.float32)
    cot = rng.standard_normal((B, H.TLEN, 16)).astype(np.float32)
    mask = np.ones((B, 1, 1, H.TLEN), bool)
    for row in range(B):
        mask[row, ..., int(rng.integers(2, H.TLEN + 1)):] = False
    mesh = jpar.get_mesh_pipe(2)
    want = {}
    for n_micro in n_micros:
        apply = jpar.make_blocks_apply(mesh, 2, n_micro)

        def scalar(xx, blocks):
            y = apply(blocks, xx, jnp.asarray(mask))
            return (y * cot).sum(), y

        (_, y), (dx, db) = jax.jit(jax.value_and_grad(
            scalar, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jblocks)
        want[n_micro] = {"y": np.asarray(y), "dx": np.asarray(dx),
                         "dblocks": _keyed({"blocks": db})}
    case = {"kind": "blocks", "mesh": (1, 2, 1), "n_heads": 2,
            "n_micro": list(n_micros), "x": x, "cot": cot, "mask": mask,
            "blocks": _keyed({"blocks": jblocks})}
    return case, want


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mixed_case():
    argv = H.flags(enc="gru")
    _, _, _, tm = H.models(argv)
    params = tm.init_params(runtime.generator("cpu", 13))
    rf = t_tv.L.init_rf_basis(runtime.generator("cpu", 14), H.Z, 16)
    steps = [(H.tokens(70 + it), H.numpy_tree(t_tv.draw_step(
        tm, runtime.generator("cpu", 15, it), H.B, H.TLEN, "cpu")))
        for it in range(H.STEPS)]
    return {"kind": "train", "argv": argv, "V": H.V, "T": H.TLEN,
            "mesh": (1, 2, 1),
            "params": {t_ck.keystr(("params",) + p): v.numpy()
                       for p, v in t_ck.flatten(params).items()},
            "rf": [a.numpy() for a in rf], "steps": steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train, want_train = H.jax_train(H.flags(), "pp")
        _, _, jm, _ = H.models(H.flags(n_layers=4))
        jblocks = jm.init_params(jax.random.PRNGKey(8))["dec"]["blocks"]
        blocks, want_blocks = [], []
        for i, (B, n_micros) in enumerate(BLOCKS):
            case, want = _jax_blocks(jblocks, B, n_micros, 20 + i)
            blocks.append(case)
            want_blocks.append(want)
        mixed = _mixed_case()
        got = H.spawn(tmp, 2, [train, mixed] + blocks)
        one = mp_check.train_case(mixed)
    finally:
        torch.set_num_threads(n)
    return types.SimpleNamespace(tmp=tmp, got=got, want_train=want_train,
                                 want_blocks=want_blocks, one=one)


@pytest.mark.parametrize("i,n_micro", [(i, m) for i, (_, ms) in
                                       enumerate(BLOCKS) for m in ms])
def test_schedule_matches_jax_make_blocks_apply(runs, i, n_micro):
    """The GPipe schedule's output, its input's gradient and every block
    leaf's, each rank's stage gathered, against JAX's (every rank holds
    the same output and input gradient)."""
    want = runs.want_blocks[i][n_micro]
    for r in range(2):
        got = runs.got[r][2 + i][n_micro]
        np.testing.assert_allclose(got["y"], want["y"], **H.TOL)
        np.testing.assert_allclose(got["dx"], want["dx"], **H.TOL)
        assert set(got["dblocks"]) == set(want["dblocks"])
        for k, v in want["dblocks"].items():
            np.testing.assert_allclose(got["dblocks"][k], v, err_msg=k,
                                       **H.TOL)


def test_pp_steps_match_jax_make_pp_model(runs):
    """3 steps on 2 stages against the JAX
    package's make_pp_model step: params, moments and metrics after each
    step; both ranks hold the same full state."""
    got = runs.got[0][0]
    for s, (g, w) in enumerate(zip(got, runs.want_train)):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])
    for k, v in got[-1]["state"].items():
        np.testing.assert_array_equal(v, runs.got[1][0][-1]["state"][k],
                                      err_msg=k)


def test_mixed_family_pp_matches_one_device(runs):
    """GRU encoder (replicated on both stages), the transformer decoder's
    blocks one a stage: 3 steps against the port's one-device step."""
    for s, (g, w) in enumerate(zip(runs.got[0][1], runs.one)):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])


def test_validation_raises_where_jax_asserts():
    """Depth not divisible by the stages, or block dropout on: the JAX
    package asserts, the port raises a ValueError with its message."""
    for argv, pp, msg in ((H.flags(n_layers=4), 3, "not divisible by "
                           "pipe=3"),
                          (H.flags(p_dropout=0.5), 2, "p_dropout == 0")):
        _, _, jm, tm = H.models(argv)
        with pytest.raises(AssertionError, match=msg):
            j_pp.validate_pp_divisibility(jm, pp)
        with pytest.raises(ValueError, match=msg):
            t_pp.validate_pp_divisibility(tm, pp)
