"""Tensor parallelism of the port on the CPU: two gloo ranks spawned by
``parallel.dist.spawn`` run ``tools/mp_check.py``'s cases once for the
module (a (1, 1, 2) mesh: one stage, two model ranks), held against

* the JAX package's ``make_tp_train_step`` on a (1, 2) mesh: params and
  Adam moments after each of 3 phase-1 steps, the transformer family
  with its blocks' dropout on (the JAX draws injected, the masks of the
  blocks' whole outputs on both ranks);
* its ``make_tp_full_step``: one phase-2 iteration;
* the port's one-device step on the same inputs: the mixed family (GRU
  encoder, sharded decoder) over 3 steps, and a checkpoint that the TP
  run wrote, read by the JAX package's ``checkpoints.load``.

The trainers under ``--hw.tp`` run in ``tests/test_torch_tp3d.py``'s
``main.main`` case (tp 2 with pp 2) and on the card (``chip_smoke.py``
``[12t]``, ``[12x]``, ``[12f]``).

Also the layout of the shards against ``transformer_param_specs``, the
divisibility errors and the mesh's refusals. Tolerances: ``mp_helpers``
(atol 5e-5 / rtol 1e-5, the JAX TP test's bound)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu.parallel import tp as j_tp
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
from controlled_peptide_generation_tpu_torch.parallel import tp as t_tp
from controlled_peptide_generation_tpu_torch.tools import mp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import runtime

import mp_helpers as H
from test_torch_phase2 import jax_full_draws

FULL_SEED = 30


def _jax_full_case():
    """One phase-2 iteration of JAX's make_tp_full_step on a (1, 2) mesh
    and the port's case of the same inputs."""
    argv = H.flags(phase=2)
    jcfg, _, jm, _ = H.models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(FULL_SEED))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(FULL_SEED + 1), H.Z, 16)
    mesh = jpar.get_mesh_2d(1, 2)
    step, _, init_state = jpar.make_tp_full_step(jm, jcfg.full, jcfg.losses,
                                                 rf, mesh, donate=False)
    p, oss = init_state(jparams)
    key = jax.random.PRNGKey(FULL_SEED + 2)
    text, lab_text = H.tokens(40), H.tokens(41)
    lab_y = np.array([0, 1, 1, 0], np.int32)
    *_, m = out = step(p, *oss, key, jnp.asarray(text), jnp.asarray(lab_text),
                       jnp.asarray(lab_y), jnp.asarray(0, jnp.int32))
    want = {"params": {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": out[0]}).items()},
        "metrics": {k: float(v) for k, v in m.items()}}
    case = {"kind": "full", "argv": argv, "V": H.V, "T": H.TLEN,
            "mesh": (1, 1, 2),
            "params": {k: np.asarray(v) for k, v in j_ck._flatten(
                {"params": jparams}).items()},
            "rf": [np.asarray(a) for a in rf],
            "steps": [(text, lab_text, lab_y, H.numpy_tree(jax_full_draws(
                jm, jcfg, key, H.B, H.B)))]}
    return case, want


def _mixed_case(tmp):
    """3 steps of the mixed family (GRU encoder) on the port's own draws;
    the TP run writes its checkpoint."""
    argv = H.flags(enc="gru")
    _, _, _, tm = H.models(argv)
    params = tm.init_params(runtime.generator("cpu", 3))
    rf = t_tv.L.init_rf_basis(runtime.generator("cpu", 4), H.Z, 16)
    steps = []
    for it in range(H.STEPS):
        d = t_tv.draw_step(tm, runtime.generator("cpu", 5, it), H.B, H.TLEN,
                           "cpu")
        steps.append((H.tokens(60 + it), H.numpy_tree(d)))
    return {"kind": "train", "argv": argv, "V": H.V, "T": H.TLEN,
            "mesh": (1, 1, 2), "save": str(tmp / "tp" / "model_3.npz"),
            "params": {t_ck.keystr(("params",) + p): v.numpy()
                       for p, v in t_ck.flatten(params).items()},
            "rf": [a.numpy() for a in rf], "steps": steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train, want_train = H.jax_train(H.flags(p_dropout=0.1), "tp")
        full, want_full = _jax_full_case()
        mixed = _mixed_case(tmp)
        cases = [train, full, mixed]
        refusals = (["--hw.tp", "2", "--hw.dp", "2"], ["--hw.tp", "4"],
                    ["--hw.tp", "2", "--hw.dp", "0"])
        cases += [{"kind": "refusal", "argv": a, "batch_sizes": [5]}
                  for a in refusals]
        got = H.spawn(tmp, 2, cases)
        one = {"mixed": mp_check.train_case(mixed)}
    finally:
        torch.set_num_threads(n)
    return types.SimpleNamespace(
        tmp=tmp, got=got, one=one, want_train=want_train,
        want_full=want_full, mixed=mixed)


def test_tp_steps_match_jax_make_tp_train_step(runs):
    """Params and moments after each of 3 steps, the transformer family
    with block dropout 0.1, against JAX's TP step on a (1, 2) mesh; every
    logged metric within 1e-5; the two ranks hold the same full state."""
    got = runs.got[0][0]
    for s, (g, w) in enumerate(zip(got, runs.want_train)):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])
    for k, v in got[-1]["state"].items():
        np.testing.assert_array_equal(v, runs.got[1][0][-1]["state"][k],
                                      err_msg=k)


def test_tp_iteration_matches_jax_make_tp_full_step(runs):
    """One phase-2 iteration (the VAE, attribute and classifier updates,
    the samplers on the decoder gathered in full) against JAX's TP
    iteration: every param and logged metric."""
    got = runs.got[0][1]["steps"][0]
    H.assert_state(got["state"], runs.want_full["params"], 2, skip=())
    H.assert_metrics(got["metrics"], runs.want_full["metrics"],
                     ["L_vae", "L_vae_recon", "L_vae_kl", "L_attr_c",
                      "L_attr_z", "L_clf_sup", "L_clf_unsup", "clf_acc"])


def test_mixed_family_tp_matches_one_device(runs):
    """GRU encoder (replicated), transformer decoder (sharded): 3 steps on
    two model ranks against the port's one-device step."""
    got, want = runs.got[0][2], runs.one["mixed"]
    for s, (g, w) in enumerate(zip(got, want)):
        H.assert_state(g["state"], w["state"], s + 1)
        H.assert_metrics(g["metrics"], w["metrics"])


def test_tp_checkpoint_loads_in_jax(runs):
    """The TP run's checkpoint (the ranks' shards gathered by the writer)
    in the JAX package's loader, with its own train-state template:
    every param and moment equals the one-device run's within TOL."""
    argv = runs.mixed["argv"]
    _, _, jm, _ = H.models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    opt = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(H.LR))
    state = j_ck.load(runs.mixed["save"],
                      {"params": jparams, "opt": opt.init(jparams)},
                      strict=False)
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(state).items()
            if "['clf']" not in k}
    H.assert_state(flat, runs.one["mixed"][-1]["state"], H.STEPS)
    assert int(flat["['opt'][1][0].count"]) == H.STEPS


def test_refusals_in_a_group_of_two(runs):
    """hw.dp x hw.pp x hw.tp must be the group's size (hw.dp 0 takes the
    rest); the message names both."""
    both, four, rest = (r["error"] for r in runs.got[0][3:6])
    assert "hw.dp 2 x hw.pp 1 x hw.tp 2 is 4 rank(s) but the process " \
           "group has 2" in both
    assert "hw.dp 1 x hw.pp 1 x hw.tp 4 is 4 rank(s)" in four
    assert rest is None


def test_refusals_without_a_group():
    for argv in (["--hw.tp", "2"], ["--hw.pp", "2"]):
        cfg, _, _ = TC.parse_and_finalize(argv)
        with pytest.raises(ValueError, match="but the process group has 1"):
            pdist.model_parallel(cfg)
    cfg, _, _ = TC.parse_and_finalize([])
    assert pdist.parallel_layout(cfg) == (None, None)


@pytest.mark.parametrize("enc", ["transformer", "gru"])
def test_shards_follow_transformer_param_specs(enc):
    """Each model rank's slice of every leaf is the JAX device shard under
    transformer_param_specs on a (1, 2) mesh (the mixed family's encoder
    replicated), and gathering the slices back gives the tree."""
    argv = H.flags(enc=enc)
    _, _, jm, tm = H.models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(2))
    jspecs = jpar.transformer_param_specs(jparams, n_heads=2, tp=2)
    tparams = t_ck.params_from_jax(H.params_flat(jparams))
    tspecs = t_ck.flatten(t_tp.param_specs(tparams))
    jflat = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, P))[0]}
    assert {t_ck.keystr(p): s for p, s in tspecs.items()} == {
        k: tuple(v) for k, v in jflat.items() if not k.startswith("['clf']")}
    if enc == "gru":
        assert all(s == () for p, s in tspecs.items() if p[0] == "enc")
    mesh = jpar.get_mesh_2d(1, 2)
    pos = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    jleaves = {k: v for k, v in j_ck._flatten(jparams).items()}
    for t in range(2):
        rank = types.SimpleNamespace(rank=t, world=2)
        mine = t_ck.flatten(t_tp.shard_tree(tparams, rank))
        for p, leaf in mine.items():
            k = t_ck.keystr(p)
            arr = jax.device_put(jleaves[k], NamedSharding(mesh, jflat[k]))
            shard = next(s for s in arr.addressable_shards
                         if pos[s.device] == t)
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(shard.data), err_msg=k)


def test_divisibility_raises_where_jax_asserts():
    """n_heads or d_ff not divisible by tp: the JAX step builder asserts,
    the port raises a ValueError with its message."""
    for flag, value, msg in (("n_heads", "3", "n_heads 3 not divisible"),
                             ("d_ff", "31", "d_ff 31 not divisible")):
        argv = H.flags() + [f"--model.G_args.T_args.{flag}", value]
        if flag == "n_heads":
            argv += ["--model.G_args.T_args.d_model", "18"]
        _, _, jm, tm = H.models(argv)
        with pytest.raises(AssertionError, match=msg):
            j_tp.validate_tp_divisibility(jm, 2)
        with pytest.raises(ValueError, match=msg):
            t_tp.validate_tp_divisibility(tm, 2)
