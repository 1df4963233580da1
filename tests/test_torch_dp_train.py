"""Phase-1 data parallelism of the port on the CPU: two gloo ranks spawned
by the port's helper (``parallel.dist.spawn``) run the DP steps of
``tools/dp_check.py`` on injected inputs, once for the whole module, and
their params and metrics are held against

* the JAX package's ``make_dp_train_step`` and ``make_dp_train_scan`` on
  a 2-device mesh (the JAX draws of the global batch injected), for the
  ``mmdrf`` and ``mmd`` regularizers and under ``rf_resample``: params
  after 3 steps within rtol 2e-4 / atol 2e-5 (the JAX DP test's bound,
  ``tests/test_parallel.py:61-64``), L_vae within 1e-4;
* the port's one-device step on the global batch (``dp_check``'s case
  without a group), for the GRU, transformer and deconv families (the
  deconv's batch norm over the global batch) and the flat Adam: params
  within the same bound, every metric within 1e-4;
* the gradient rule of the z gather, and a tiny ``main.main`` run at
  ``--hw.dp 2`` (chunks of 5 steps) against ``--hw.dp 1``.

The refusals: ``hw.dp`` against the group's size, ``batch_size %% dp``,
a gloo chunk on CUDA tensors (by the selector alone), ``hw.tp`` /
``hw.pp`` without a group of their ranks."""

import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
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
from controlled_peptide_generation_tpu_torch.tools import dp_check
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import train_vae as t_tv
from controlled_peptide_generation_tpu_torch.utils import runtime

from test_torch_train import _jax_draws, _tokens

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
LOSS_TOL = 1e-4
V, TLEN, B, STEPS = 13, 7, 8, 3
SMALL = ["--model.z_dim", "12", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "8", "--max_seq_len", str(TLEN),
         "--losses.wae_mmd.rf_dim", "16", "--phase", "1"]
TFM_FLAGS = ["--model.E_args.E_class", "transformer",
             "--model.G_args.G_class", "transformer"]
for _part in ("E_args", "G_args"):
    for _k, _v in (("d_model", 16), ("d_ff", 32), ("n_heads", 2),
                   ("n_layers", 2), ("p_dropout", 0.1)):
        TFM_FLAGS += [f"--model.{_part}.T_args.{_k}", str(_v)]
DECONV_T = 25
DECONV_FLAGS = ["--model.z_dim", "6", "--model.emb_dim", "10",
                "--model.E_args.h_dim", "5", "--losses.wae_mmd.rf_dim", "16",
                "--model.G_args.deconv_args.num_filters", "8",
                "--model.G_args.G_class", "deconv",
                "--max_seq_len", str(DECONV_T), "--phase", "1"]
JAX_CASES = {"mmdrf": ["--vae.z_regu_loss", "mmdrf"],
             "mmd": ["--vae.z_regu_loss", "mmd"],
             "rf_resample": ["--vae.z_regu_loss", "mmdrf",
                             "--losses.wae_mmd.rf_resample", "1"]}
PORT_CASES = {"gru": (SMALL, TLEN, False), "flat": (SMALL, TLEN, True),
              "transformer": (SMALL + TFM_FLAGS, TLEN, False),
              "deconv": (DECONV_FLAGS, DECONV_T, False)}


def _jax_params_flat(jparams):
    return {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jparams.items() if k != "clf"}}).items()}


def _jax_case(name):
    """The JAX DP run of case ``name`` (3 steps of make_dp_train_step on a
    2-device mesh, and make_dp_train_scan over the same 3) and the port
    case carrying its inputs."""
    argv = SMALL + JAX_CASES[name]
    jcfg, _, _ = JC.parse_and_finalize(argv)
    jm = j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    resample = jcfg.losses.wae_mmd.rf_resample
    rf = None if resample else j_L.init_rf_basis(
        jax.random.PRNGKey(1), jm.z_dim, jcfg.losses.wae_mmd.rf_dim)
    mesh = jpar.get_mesh(2)
    step, opt = jpar.make_dp_train_step(jm, jcfg.vae, jcfg.losses, rf, mesh,
                                        donate=False)
    key = jax.random.PRNGKey(7)
    texts = np.stack([_tokens(20 + it, B) for it in range(STEPS)])
    p = jpar.replicate(mesh, jparams)
    o = jpar.replicate(mesh, opt.init(jparams))
    losses, steps = [], []
    for it in range(STEPS):
        k_it = jax.random.fold_in(key, it)
        p, o, m = step(p, o, k_it, jpar.shard_batch(mesh, jnp.asarray(
            texts[it])), jnp.asarray(it, jnp.int32))
        losses.append(float(m["L_vae"]))
        draws = {k: v.numpy() for k, v in _jax_draws(jm, k_it,
                                                      texts[it]).items()}
        if resample:
            k_basis = jax.random.split(k_it, 4)[3]
            rf_w, rf_b = j_L.init_rf_basis(k_basis, jm.z_dim,
                                           jcfg.losses.wae_mmd.rf_dim)
            draws.update(rf_w=np.asarray(rf_w), rf_b=np.asarray(rf_b))
        steps.append((texts[it], draws))
    want = {"params": j_ck._flatten({"params": p}), "L_vae": losses}
    if not resample:
        chunk, _ = jpar.make_dp_train_scan(jm, jcfg.vae, jcfg.losses, rf,
                                           mesh, STEPS, donate=False)
        from jax.sharding import NamedSharding, PartitionSpec as P
        pc, _, _ = chunk(jpar.replicate(mesh, jparams),
                         jpar.replicate(mesh, opt.init(jparams)), key,
                         jax.device_put(jnp.asarray(texts), NamedSharding(
                             mesh, P(None, "data"))),
                         jnp.asarray(0, jnp.int32))
        want["scan_params"] = j_ck._flatten({"params": pc})
    case = {"kind": "train", "argv": argv, "V": V, "T": TLEN,
            "params": _jax_params_flat(jparams),
            "rf": None if rf is None else [np.asarray(a) for a in rf],
            "steps": steps}
    return case, want


def _port_case(name):
    """A case of the port's own draws (draw_step of the global batch) and
    seeded params, for the DP against the one-device step."""
    argv, T, flat = PORT_CASES[name]
    cfg, _, _ = TC.parse_and_finalize(argv)
    model = t_build(cfg.model, n_vocab=V, max_seq_len=T)
    params = model.init_params(runtime.generator("cpu", 3))
    rf = [a.numpy() for a in t_tv.L.init_rf_basis(
        runtime.generator("cpu", 4), model.z_dim, cfg.losses.wae_mmd.rf_dim)]
    steps = []
    for it in range(STEPS):
        text = _tokens(40 + it, B) if T == TLEN else _long_tokens(it, T)
        draws = t_tv.draw_step(model, runtime.generator("cpu", 5, it), B, T,
                               "cpu")
        steps.append((text, {k: ([x.numpy() for x in v] if isinstance(v, list)
                                 else v.numpy()) for k, v in draws.items()}))
    return {"kind": "train", "argv": argv, "V": V, "T": T, "flat": flat,
            "params": {t_ck.keystr(("params",) + p): v.numpy()
                       for p, v in t_ck.flatten(params).items()},
            "rf": rf, "steps": steps}


def _long_tokens(seed, T):
    rng = np.random.default_rng(seed)
    tok = np.full((B, T), 1, np.int32)
    for row in range(B):
        k = int(rng.integers(5, T - 2))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def _cli_argv(tmp, name, dp):
    """A small phase-1 run: 21 steps of batch 8, logs every 10, one
    checkpoint (20), chunks of 5 steps."""
    return SMALL[:6] + [
        "--phase", "1", "--dataset", "synthetic", "--device", "cpu",
        "--savepath_toplevel", str(tmp / "out"), "--tb_toplevel",
        str(tmp / "tb"), "--datapath", str(tmp / "data"), "--runname", name,
        "--vae.n_iter", "20", "--vae.batch_size", "8",
        "--vae.cheaplog_every", "10", "--vae.expsvlog_every", "20",
        "--evals.sample_size", "4", "--resume_result_json", "0",
        "--hw.unroll", "5", "--hw.dp", str(dp)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on two gloo ranks in one spawn, and its references."""
    tmp = tmp_path_factory.mktemp("dp_train")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases, want = [], {}
        for name in JAX_CASES:
            case, want[name] = _jax_case(name)
            cases.append(case)
        for name in PORT_CASES:
            case = _port_case(name)
            want[name] = dp_check.train_case(case)
            cases.append(case)
        z = np.random.default_rng(0).standard_normal((8, 3)).astype(
            np.float32)
        cases.append({"kind": "gather", "z": z})
        cases.append({"kind": "main", "argv": _cli_argv(tmp, "dp2", 2)})
        for dp in (1, 3, 0):
            cases.append({"kind": "refusal", "argv": ["--hw.dp", str(dp)],
                          "batch_sizes": [8]})
        cases.append({"kind": "refusal", "argv": ["--hw.dp", "2"],
                      "batch_sizes": [5]})
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
    names = list(JAX_CASES) + list(PORT_CASES)
    return types.SimpleNamespace(
        tmp=tmp, want=want, z=z,
        got={nm: got[0][i] for i, nm in enumerate(names)},
        other={nm: got[1][i] for i, nm in enumerate(names)},
        gather=[g[len(names)] for g in got],
        refusals=[r["error"] for r in got[0][len(names) + 2:]])


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_dp_steps_match_jax_dp_step(runs, name):
    got, want = runs.got[name], runs.want[name]
    assert set(got["params"]) == set(want["params"]) - {
        k for k in want["params"] if k.startswith("['params']['clf']")}
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, np.asarray(want["params"][k]),
                                   err_msg=k, **PARAM_TOL)
        if "scan_params" in want:
            np.testing.assert_allclose(v, np.asarray(want["scan_params"][k]),
                                       err_msg=k, **PARAM_TOL)
    for m, loss in zip(got["metrics"], want["L_vae"]):
        assert abs(m["L_vae"] - loss) < LOSS_TOL


@pytest.mark.parametrize("name", list(JAX_CASES) + list(PORT_CASES))
def test_ranks_hold_the_same_params(runs, name):
    for k, v in runs.got[name]["params"].items():
        np.testing.assert_array_equal(v, runs.other[name]["params"][k],
                                      err_msg=k)


# leaves whose exact gradient is 0, so that theirs is rounding noise, which
# Adam scales to up to lr a step either way (two runs within 2 lr a
# step): the attention keys' bias
# (softmax ignores a shift shared by all keys; the fused projection is
# head-major, [heads, q k v, dh]) and, in the deconv family, the biases
# and the last scale ahead of a batch norm (tests/test_torch_deconv.py)
DECONV_ZERO = tuple(f"['{n}']['b']" for n in (
    "deconv0", "deconv1", "conv0", "conv1", "deconv_out", "final_conv")) + (
    "['bn_out']['scale']",)


def _noise(key, shape):
    mask = np.zeros(shape, bool)
    if key.endswith("['qkv']['b']"):
        mask.reshape(2, 3, -1)[:, 1] = True
    elif "['dec']" in key and key.endswith(DECONV_ZERO):
        mask[...] = True
    return mask


@pytest.mark.parametrize("name", list(PORT_CASES))
def test_dp_steps_match_the_one_device_step(runs, name):
    """The DP step on two ranks against the port's step on the global
    batch: every param after 3 steps (the leaves of zero gradient within 6
    lr), every logged metric each step, and the (per-leaf or flat) Adam
    moments, but for the entries of those leaves (rounding noise)."""
    got, want = runs.got[name], runs.want[name]
    for k, v in want["params"].items():
        noise = _noise(k, v.shape)
        assert np.abs(got["params"][k] - v)[noise].max(initial=0) <= 6e-3
        np.testing.assert_allclose(got["params"][k][~noise], v[~noise],
                                   err_msg=k, **PARAM_TOL)
    for gm, wm in zip(got["metrics"], want["metrics"]):
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_TOL,
                                       atol=1e-6, err_msg=k)
    for k, v in want["opt"].items():
        noise = _noise(k, np.shape(v))
        np.testing.assert_allclose(np.asarray(got["opt"][k])[~noise],
                                   np.asarray(v)[~noise], rtol=1e-3,
                                   atol=1e-7, err_msg=k)


def test_gather_keeps_own_rows_of_its_gradient(runs):
    """d sum(z_all^2) / d z_r through the gather: every rank computes the
    same global term, so its own rows of its own gradient are 2 z_r, and
    the backward returns world times that, which the gradients' average
    over the ranks divides back. torch.distributed.nn's all_gather sums
    the ranks' identical gradients to the same numbers with one more
    collective; summed over the ranks instead of averaged, either would
    count the term twice."""
    for r, g in enumerate(runs.gather):
        own = runs.z[4 * r:4 * (r + 1)]
        np.testing.assert_allclose(g["own_rows"], 2 * 2 * own, rtol=1e-6)
        np.testing.assert_allclose(g["torch_nn"], g["own_rows"], rtol=1e-6)


def test_cli_dp2_matches_dp1(runs):
    """main.main at --hw.dp 2 (two gloo ranks, chunks of 5 steps) against
    --hw.dp 1 on the same seed: the checkpoint's params and Adam moments,
    and the logged losses; rank 0 alone wrote the outputs."""
    out = runs.tmp / "out"
    a = np.load(out / "dp2" / "model_20.npz")
    b = np.load(out / "dp1" / "model_20.npz")
    assert set(a.files) == set(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **PARAM_TOL)
    assert int(a["['opt'][1][0].count"]) == 21
    rows = []
    for run in ("dp2", "dp1"):
        with open(out / run / "result.json") as fh:
            rows.append(json.load(fh))
    assert len(rows[0]) == len(rows[1]) > 0
    for got, want in zip(*rows):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k.startswith("train_L_"):
                np.testing.assert_allclose(got[k], v, rtol=LOSS_TOL,
                                           err_msg=k)
    assert os.path.exists(out / "dp2" / "vae_gen.txt")


def test_refusals_in_a_group_of_two(runs):
    """hw.dp 1 and 3 under two ranks raise naming the group's size, hw.dp
    0 takes it, and a batch that does not divide raises the JAX
    message."""
    one, three, zero, batch = runs.refusals
    assert "hw.dp 1 but the process group has 2 rank(s)" in one
    assert "hw.dp 3 but the process group has 2 rank(s)" in three
    assert zero is None
    assert batch == "batch_size 5 must divide over 2 devices"


def test_refusals_without_a_group():
    cfg, _, _ = TC.parse_and_finalize(["--hw.dp", "2"])
    with pytest.raises(ValueError, match="hw.dp 2 but the process group "
                                         "has 1 rank"):
        pdist.data_parallel(cfg, [8])
    for dp in ("0", "1"):
        cfg, _, _ = TC.parse_and_finalize(["--hw.dp", dp])
        assert pdist.data_parallel(cfg, [5]) is None
    for flag in ("tp", "pp"):
        cfg, _, _ = TC.parse_and_finalize([f"--hw.{flag}", "2"])
        with pytest.raises(ValueError, match="but the process group has "
                                             "1: run one process a rank"):
            pdist.parallel_layout(cfg, [8])
    cfg, _, _ = TC.parse_and_finalize(["--hw.dp", "0", "--hw.zero", "1"])
    assert pdist.parallel_layout(cfg, [8]) == (None, None)


def test_gloo_chunk_on_cuda_refused_by_the_selector():
    """A chunk of more than one step under gloo on CUDA tensors raises
    naming --hw.unroll 1; one step, NCCL, or CPU tensors pass (the
    selector reads the shard's backend and the device alone)."""
    gloo = types.SimpleNamespace(backend="gloo")
    with pytest.raises(ValueError, match="--hw.unroll 1"):
        t_tv.check_chunk(gloo, "cuda", 50)
    t_tv.check_chunk(gloo, "cuda", 1)
    t_tv.check_chunk(gloo, "cpu", 50)
    t_tv.check_chunk(types.SimpleNamespace(backend="nccl"), "cuda", 50)
    t_tv.check_chunk(None, "cuda", 50)
