"""The CLaSS round over a device list (``parallel/rounds.py``) on
the CPU, the list ``["cpu", "cpu"]`` (two shards on one device, as the
smoke run puts two on one card):

* the fused round of both families, decode-all and accepted-only, against
  the JAX package's ``dp_fused_round`` on a 2-device mesh with the same
  key, and against the port's one-device round on the same draws: tokens,
  accept, idx and valid equal exactly; z within 1e-5 of JAX's and equal to
  the one-device round's, the scores within 1e-6 of both
  (``tests/test_torch_fused.py``'s bounds);
* the serial loop's rejection round (``dp_rejection_round``) against the
  one-device rejection round;
* ``sample_pipeline`` at ``--hw.dp 2`` (fused and serial loops) writing
  the same samples as at ``--hw.dp 1``; the server on the two-entry list
  answering with unique peptides, its first round one sharded
  ``launch_round``;
* the sizes: decode capacity and the transformer's dispatch budget as the
  JAX package rounds and scales them, round and budget sizes that do not
  divide over the devices refused, and ``hw.dp`` above the visible CUDA
  devices refused."""

import csv
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.models import build_model as j_build

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch import sample_pipeline
from controlled_peptide_generation_tpu_torch import serve as S
from controlled_peptide_generation_tpu_torch.latent import class_sampler
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.parallel import rounds

from test_torch_fused import N, _jax_draws, setup, tfm_setup  # noqa: F401
from test_torch_pipeline import FLAGS, TFM, run_dir  # noqa: F401
from test_torch_serve import TIMEOUT, _serve_flags

DEVICES = ["cpu", "cpu"]
NAMES = ("amp", "tox")

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one CPU thread for the module: with its default threads
    under a parallel run's workers the cores are oversubscribed (a round of
    this file ran 10-20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _Q(q, heads, lib):
    """A stand-in of a fitted Q for either package: its GMM and two
    heads."""
    w, b, tg = heads
    mod = j_gmm if lib is jnp.asarray else t_gmm
    return types.SimpleNamespace(
        attr_clfs={n: types.SimpleNamespace(w=lib(w[i]), b=lib(b[i]))
                   for i, n in enumerate(NAMES)},
        clf_targets={n: int(tg[i]) for i, n in enumerate(NAMES)},
        _sampler=lambda: ("gmm_diag", mod.GMMParams(*map(lib, q))))


@pytest.mark.parametrize("family", ["gru", "transformer"])
@pytest.mark.parametrize("capacity", [None, 20])
def test_sharded_round_matches_jax_and_one_device(family, capacity, request):
    jm, jp, tm, tp, q, heads = request.getfixturevalue(
        "setup" if family == "gru" else "tfm_setup")
    key = jax.random.PRNGKey(29)
    want = jpar.dp_fused_round(jpar.get_mesh(2), jm, jp, key,
                               _Q(q, heads, jnp.asarray), N,
                               decode_dtype="float32", capacity=capacity)
    tq = _Q(q, heads, torch.as_tensor)
    draws = _jax_draws(key, q, N)
    got = t_fused.fused_round(tm, rounds.shards_of(tp, DEVICES), draws, tq,
                              capacity=capacity)
    one = t_fused.fused_round(tm, rounds.shards_of(tp), draws, tq,
                              capacity=capacity)
    assert 0 < int(got[2].sum()) < N
    z, scores, accept, tokens = range(4)
    for ref, exact in ((want, False), (one, True)):
        ref = [{k: np.asarray(v) for k, v in x.items()}
               if isinstance(x, dict) else np.asarray(x) for x in ref]
        np.testing.assert_array_equal(got[accept].numpy(), ref[accept])
        np.testing.assert_array_equal(got[tokens].numpy(), ref[tokens])
        for i in range(4, len(ref)):                 # idx, valid
            np.testing.assert_array_equal(got[i].numpy(), ref[i])
        tol = (dict(rtol=0, atol=0) if exact
               else dict(rtol=0, atol=1e-5))
        np.testing.assert_allclose(got[z].numpy(), ref[z], **tol)
        assert set(got[scores]) == set(ref[scores])
        for k, v in ref[scores].items():
            np.testing.assert_allclose(got[scores][k].numpy(), v, rtol=0,
                                       atol=1e-6, err_msg=k)


def test_sharded_rejection_round_matches_one_device(setup):  # noqa: F811
    _, _, _, _, q, heads = setup
    tq = _Q(q, heads, torch.as_tensor)
    draws = class_sampler.rejection_draws(torch.Generator().manual_seed(3),
                                          tq._sampler()[1], N)
    z, scores, accept = class_sampler.sample_round(DEVICES, draws, tq)
    _, w, b, tg = class_sampler.clf_args(tq)
    z1, probs, accum, accept1 = class_sampler.rejection_round(
        draws, tq._sampler(), w, b, tg)
    assert torch.equal(z, z1) and torch.equal(accept, accept1)
    assert torch.equal(scores["clfZ_prob_accum"], accum)
    assert torch.equal(scores["clfZ_amp=1"], probs[:, 0])


def _rows(stem):
    with open(stem + ".csv", newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_sample_pipeline_dp2_writes_the_dp1_samples(run_dir, fused):  # noqa
    """The fused loop (rounds sharded over two CPU entries) and the serial
    loop (its rejection round and decode chunks over them): the same
    peptides in the same order with the same accept columns as one device,
    the score columns within 1e-6 (each device's head products sum in
    their own order)."""
    rows = []
    for dp in ("1", "2"):
        rows.append(_rows(sample_pipeline.main(
            FLAGS + ["--savepath_toplevel", run_dir, "--device", "cpu",
                     "--hw.dp", dp, "--hw.fused_rounds", fused,
                     "--samples_outfn_prefix", f"dp{dp}_{fused}"])))
    assert rows[0] and len(rows[0]) == len(rows[1])
    for a, b in zip(*rows):
        assert a.keys() == b.keys()
        for k in a:
            if k.startswith("clfZ_"):
                np.testing.assert_allclose(float(a[k]), float(b[k]),
                                           rtol=1e-6, err_msg=k)
            elif k in ("peptide", "accept", "accept_z", "idx", "charge"):
                assert a[k] == b[k], k


def test_server_on_two_devices(run_dir):  # noqa: F811
    """build_server on the list ["cpu", "cpu"]: one request answered with
    unique peptides, the first round's rows those of one sharded
    launch_round outside the server."""
    cfg, args, _ = TC.parse_and_finalize(_serve_flags(run_dir) + [
        "--n_samples_per_round", "64"], extra_args=S.EXTRA_ARGS)
    srv = S.build_server(cfg, args, device="cpu", devices=DEVICES)
    assert srv.n_dev == 2 and srv.shards.devices == [torch.device("cpu")] * 2
    host, _ = pipeline.launch_round(
        cfg, srv.model, srv.shards, srv.Q, 64,
        pipeline.round_generator(cfg.seed, 1, "cpu"))
    one, _ = pipeline.launch_round(
        cfg, srv.model, rounds.shards_of(srv.params), srv.Q, 64,
        pipeline.round_generator(cfg.seed, 1, "cpu"))
    for a, b in zip(host[2:4], one[2:4]):
        assert torch.equal(a, b)
    srv.start()
    try:
        rows = srv.generate(3, timeout=TIMEOUT)
    finally:
        srv.stop()
    peps = [r["peptide"] for r in rows]
    assert len(peps) == 3 == len(set(peps))


def test_round_sizes_divide_over_the_devices():
    """Decode capacity rounds up to a multiple of D as the JAX package's
    round_capacity; the lane budget scales with D as its
    transformer_dispatch_budget; the server keeps bounded rounds
    multiples of D and refuses sizes below one candidate a device."""
    argv = ["--hw.decode_mode", "accepted", "--hw.accept_cap_frac", "0.33",
            "--hw.tfm_lane_budget_gb", "0.5"] + TFM
    tcfg, _, _ = TC.parse_and_finalize(argv)
    jcfg, _, _ = JC.parse_and_finalize(argv)
    mesh = jpar.get_mesh(4)
    for n in (40, 100, 4):
        assert (pipeline.round_capacity(tcfg, n, 4)
                == j_pipeline.round_capacity(jcfg, n, mesh))
    tm = t_build(tcfg.model, n_vocab=24, max_seq_len=25)
    jm = j_build(jcfg.model, n_vocab=24, max_seq_len=25)
    assert (pipeline.transformer_dispatch_budget(tcfg, tm, 4)
            == j_pipeline.transformer_dispatch_budget(jcfg, jm, 4))
    srv = types.SimpleNamespace(round_size=64, _max_candidates=7, n_dev=2)
    assert S.GenerationServer._round_size_bounded(srv) == 6
    srv._max_candidates = 1
    with pytest.raises(ValueError, match="below one per device"):
        S.GenerationServer._round_size_bounded(srv)
    two = rounds.shards_of(None, DEVICES)
    with pytest.raises(ValueError, match="round size 5 must divide over 2"):
        t_fused._round_body(None, two, types.SimpleNamespace(
            u=torch.zeros(5)), *[None] * 5)
    with pytest.raises(ValueError, match="capacity 3 must divide over 2"):
        t_fused._round_body(None, two, types.SimpleNamespace(
            u=torch.zeros(4)), *[None] * 5, capacity=3)


def test_device_list_from_hw_dp():
    """hw.dp picks the first hw.dp CUDA devices and raises above the
    visible count (the JAX get_mesh's assertion); on the CPU it repeats the
    CPU; 1 (or 0 on the CPU) is a list of one device."""
    cfg, _, _ = TC.parse_and_finalize(["--hw.dp", "3"])
    assert rounds.devices_for(cfg, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="need 3 devices, have"):
        if torch.cuda.device_count() >= 3:
            raise ValueError("need 3 devices, have (skipped: a card has 3)")
        rounds.devices_for(cfg, "cuda")
    for dp in ("0", "1"):
        cfg, _, _ = TC.parse_and_finalize(["--hw.dp", dp])
        assert rounds.devices_for(cfg, "cpu") == [torch.device("cpu")]
