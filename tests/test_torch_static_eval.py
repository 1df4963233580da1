"""The port's inference API and static eval on the CPU.

The API against the JAX package's ``api.py`` on the same weights (small
widths, T 10): ``interpolate_z`` exactly, ``encode_sequence`` within rtol
1e-5, ``sample_from_model`` token-equal with z and c injected, greedy and
beam 5 (n_best 3), and the same ``pretty_print_samples`` strings. The beam
route of ``generate_sentences``, decided before the call. End to end: the
port's ``static_eval --long`` on a run dir the port trained, then its
``sample_pipeline`` from that dump with h5py hidden, as on the H100
machine."""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import api as j_api
from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import api
from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import generation
from controlled_peptide_generation_tpu_torch import main as t_main
from controlled_peptide_generation_tpu_torch import sample_pipeline
from controlled_peptide_generation_tpu_torch import static_eval
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import beam as beam_ops
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.vis import build_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "amp", "vocab.dict")
SMALL = ["--model.z_dim", "12", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "8", "--max_seq_len", "10"]
SEQS = ["M L L L L L A L A L L A L L L A L L L", "M S S S S S L A A A L L",
        "K W K L F K K I G", "G"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread: the tiny shapes here are faster so, and a
    worker of a parallel test run does not fight the others for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX model and params at small widths, and the port's on the
    same weights (the classifier left out), with both vocabs."""
    jcfg, _, _ = JC.parse_and_finalize(SMALL)
    tcfg, _, _ = TC.parse_and_finalize(SMALL)
    jm = j_build(jcfg.model, n_vocab=24, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(6))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jp.items() if k != "clf"}}).items()}
    tm = t_build(tcfg.model, n_vocab=24, max_seq_len=10)
    return (jm, jp, j_api.load_vocab(VOCAB), tm, t_ck.params_from_jax(flat),
            api.load_vocab(VOCAB))


def test_interpolate_z_matches_jax():
    """All three methods, slerp also between parallel and equal endpoints
    (its guard), exactly as the JAX package computes them."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((1, 12)).astype(np.float32)
    b = rng.standard_normal((1, 12)).astype(np.float32)
    cases = [(m, a, b) for m in ("linear", "tanh", "slerp")]
    cases += [("slerp", a, 2 * a), ("slerp", a, a)]
    for method, z0, z1 in cases:
        want_z, want_w = j_api.interpolate_z(z0, z1, method=method,
                                             n_samples=9)
        got_z, got_w = api.interpolate_z(torch.from_numpy(z0), z1,
                                         method=method, n_samples=9)
        assert got_z.dtype == want_z.dtype
        np.testing.assert_array_equal(got_z, want_z)
        assert got_w == want_w
        assert np.isfinite(got_z).all()
    with pytest.raises(ValueError):
        api.interpolate_z(a, b, method="cubic")


def test_encode_sequence_matches_jax(models):
    jm, jp, jv, tm, tp, tv = models
    for seq in SEQS:
        want = j_api.encode_sequence(jm, jp, jv, seq)
        got = api.encode_sequence(tm, tp, tv, seq)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    drawn = api.encode_sequence(tm, tp, tv, SEQS[0], sample_q=4)
    assert drawn.shape == (4, 12) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("kwargs", [
    {"sample_mode": "greedy"},
    {"sample_mode": "beam", "beam_size": 5, "n_best": 3},
], ids=["greedy", "beam"])
def test_sample_from_model_matches_jax(models, kwargs):
    """z and c injected: the same words per sample (per hypothesis in the
    beam mode) and the same printed lines, all hypotheses or the first."""
    jm, jp, jv, tm, tp, tv = models
    rng = np.random.default_rng(4)
    n = 6
    z = rng.standard_normal((n, 12)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    want = j_api.sample_from_model(jm, jp, jv, z=jnp.asarray(z),
                                   c=jnp.asarray(c), n_samples=n, **kwargs)
    got = api.sample_from_model(tm, tp, tv, z=z, c=c, n_samples=n, **kwargs)
    assert got["predictions"] == want["predictions"]
    assert len(got["predictions"][0]) == (3 if "n_best" in kwargs else 1)
    for every in (True, False):
        assert (api.pretty_print_samples(got["predictions"], every)
                == j_api.pretty_print_samples(want["predictions"], every))


def _gru_and_tfm(T):
    cfg, _, _ = TC.parse_and_finalize(["--model.z_dim", "12"])
    out = []
    for fam in ("gru", "transformer"):
        cfg.model.E_args.E_class = cfg.model.G_args.G_class = fam
        m = t_build(cfg.model, n_vocab=24, max_seq_len=T)
        out.append((m, m.init_params(torch.Generator().manual_seed(0))))
    return out


def test_beam_route_is_decided_before_the_call(monkeypatch):
    """Beam 15 at T 25 (T*K 375 > 256) is outside both kernels' scope:
    generate_sentences passes plain=True, as the JAX package runs it in
    its XLA arm; beam 5 is inside and passes plain=False, which on CUDA
    tensors launches B1 / B3. The decision reads the model, the beam and
    the type only (no tensor is decoded here)."""
    routes = []

    def record(model, params, z, c, beam_size, n_best, min_length, plain):
        routes.append((model.G_class, beam_size, plain))
        hyps = torch.zeros((z.shape[0], n_best, model.max_seq_len + 1),
                           dtype=torch.long)
        return hyps, torch.zeros((z.shape[0], n_best))

    monkeypatch.setattr(beam_ops, "beam_search", record)
    for model, params in _gru_and_tfm(25):
        for K in (15, 5):
            generation.generate_sentences(
                model, params, 2, gen=torch.Generator().manual_seed(1),
                sample_mode="beam", beam_size=K, n_best=3)
    assert routes == [("gru", 15, True), ("gru", 5, False),
                      ("transformer", 15, True), ("transformer", 5, False)]


def test_plain_beam_runs_are_counted():
    """beam_search.plain_runs counts the plain=True calls only."""
    (model, params), _ = _gru_and_tfm(6)
    z = torch.zeros((1, 12))
    c = model.c_from_bits(torch.tensor([True]))
    before = beam_ops.beam_search.plain_runs
    beam_ops.beam_search(model, params, z, c, beam_size=3, n_best=1)
    beam_ops.beam_search(model, params, z, c, beam_size=3, n_best=1,
                         plain=True)
    assert beam_ops.beam_search.plain_runs == before + 1


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run dir the port trained: 4 phase-1 steps on the amp corpus at
    small widths (no tensorboard, as on the card)."""
    top = str(tmp_path_factory.mktemp("static_eval"))
    flags = SMALL + ["--dataset", "amp", "--datapath",
                     os.path.join(REPO, "data"), "--runname", "tiny",
                     "--savepath_toplevel", os.path.join(top, "out"),
                     "--tb_toplevel", os.path.join(top, "tb"),
                     "--vae.n_iter", "4", "--vae.batch_size", "8",
                     "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        cfg = t_main.main(flags + ["--phase", "1", "--vae.expsvlog_every",
                                   "2", "--vae.cheaplog_every", "2",
                                   "--losses.wae_mmd.rf_dim", "16"])
    finally:
        mp.undo()
    return cfg, flags


def test_static_eval_then_sample_pipeline(port_run, capsys, monkeypatch):
    """static_eval --long writes the three dumps (both formats here) and
    the index and prints the battery; sample_pipeline then samples from
    that dump with h5py hidden (the .npz alone)."""
    cfg, flags = port_run
    monkeypatch.setattr(static_eval, "MAX_EXAMPLES", 200)
    summary = static_eval.main(flags + ["--long"])
    out = capsys.readouterr().out
    assert "#### reco of" in out and " - hyp 2: " in out
    assert "recon interpol - w=1.00" in out
    for split in ("train", "val", "test"):
        path = build_index.states_path(cfg.savepath, split, 4)
        assert summary["states"][split] == path
        assert os.path.exists(path)
        assert build_index.read_states(path)["mu"].shape == (200, 12)
    assert set(summary["seconds"]) == {"train", "val", "test", "battery"}
    index = build_index.LatentIndex.load(summary["index"])
    assert tuple(index.z.shape) == (200, 12)

    monkeypatch.setitem(sys.modules, "h5py", None)
    stem = sample_pipeline.main(flags + [
        "--n_samples_per_round", "300", "--n_samples_acc", "20",
        "--Q_n_components", "4"])
    assert os.path.exists(stem + ".plain.txt")
    assert len(glob.glob(stem + ".accepted.*.csv")) == 1
