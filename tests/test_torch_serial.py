"""The port's serial CLaSS loop (``hw.fused_rounds=0``) against the JAX
package's on the CPU: the rejection round under the JAX round's own draws
(recomputed from its key: latent/class_sampler.py and latent/gmm.py:sample
there), the chunked beam decode with JAX's per-chunk c injected (each
chunk's c from ``fold_in(key, s)`` as generation.generate_sentences draws
it), both serial loops fed the same round frames, and the CLI end to end.

Tolerances: z 1e-5 and probs and accum 1e-6 absolute (fp32 products summed
in XLA's order and in torch's: on the same z, probs near 0 differ by up to
5e-6 relative); accept masks, tokens, peptides and the loops' frames
exactly."""

import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.api import load_vocab as j_load_vocab
from controlled_peptide_generation_tpu.latent import class_sampler as j_cs
from controlled_peptide_generation_tpu.latent import density as j_density
from controlled_peptide_generation_tpu.latent import logreg as j_logreg
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch import sample_pipeline
from controlled_peptide_generation_tpu_torch.api import load_vocab
from controlled_peptide_generation_tpu_torch.latent import class_sampler
from controlled_peptide_generation_tpu_torch.latent import density
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.latent import logreg
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

from test_torch_pipeline import FLAGS, run_dir  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "data", "amp", "vocab.dict")
D = 12


def _q_and_heads(seed):
    rng = np.random.default_rng(seed)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, D)).astype(np.float32),
         (0.5 + rng.random((4, D))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, D))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    return q, heads


def _jax_rejection_draws(key, q, n):
    """JAX _rejection_round's draws: split(key) -> (kz, ku); gmm.sample
    splits kz -> (component, eps)."""
    kz, ku = jax.random.split(key)
    kc, ke = jax.random.split(kz)
    comp = jax.random.categorical(kc, jnp.log(jnp.asarray(q[0])), shape=(n,))
    eps = jax.random.normal(ke, (n, q[1].shape[1]))
    u = jax.random.uniform(ku, (n,))
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return class_sampler.RejectionDraws(T(comp), T(eps), T(u))


@pytest.mark.parametrize("n", [1, 200])
def test_rejection_round_matches_jax(n):
    """Under the JAX round's draws: z within 1e-5, probs and accum within
    1e-6, the accept mask exactly; on JAX's own z (fed through a GMM of
    one standard component, z = eps bit for bit) the same."""
    q, heads = _q_and_heads(3)
    key = jax.random.PRNGKey(11)
    jq = j_density.gmm_mod.GMMParams(*map(jnp.asarray, q))
    want = [np.array(a) for a in j_cs.rejection_round(
        key, ("gmm_diag", jq), *map(jnp.asarray, heads), n)]
    tq = t_gmm.GMMParams(*map(torch.from_numpy, q))
    draws = _jax_rejection_draws(key, q, n)
    t_heads = list(map(torch.from_numpy, heads))
    got = [a.numpy() for a in class_sampler.rejection_round(
        draws, ("gmm_diag", tq), *t_heads)]
    unit = t_gmm.GMMParams(torch.ones(1), torch.zeros((1, D)),
                           torch.ones((1, D)))
    on_z = [a.numpy() for a in class_sampler.rejection_round(
        class_sampler.RejectionDraws(
            torch.zeros(n, dtype=torch.int64), torch.from_numpy(want[0]),
            draws.u), ("gmm_diag", unit), *t_heads)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)    # z
    np.testing.assert_array_equal(on_z[0], want[0])
    for out in (got, on_z):
        np.testing.assert_allclose(out[1], want[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[2], want[2], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out[3], want[3])                # accept
    if n > 1:
        assert 0 < want[3].sum() < n
    # the compaction into a fixed-shape buffer
    for cap in (1, 5, n + 3):
        wz, wc = j_cs.accepted_z(jnp.asarray(want[0]), jnp.asarray(want[3]),
                                 cap)
        gz, gc = class_sampler.accepted_z(torch.from_numpy(want[0]),
                                          torch.from_numpy(want[3]), cap)
        assert int(gc) == int(wc)
        np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))


def test_rejection_sample_matches_jax():
    """Q.rejection_sample of fullQ: the same score keys and values as the
    JAX package's on its draws; a generator's draws repeat with its
    seed."""
    rng = np.random.default_rng(5)
    mu = rng.standard_normal((30, D)).astype(np.float32)
    logvar = np.full((30, D), -1.0, np.float32)
    _, heads = _q_and_heads(6)
    jq = j_density.fullQ(mu, logvar)
    jq.init_attr_classifiers(
        {a: j_logreg.LogRegParams(jnp.asarray(heads[0][i]),
                                  jnp.asarray(heads[1][i]))
         for i, a in enumerate(("amp", "tox"))}, {"amp": 1, "tox": 0})
    tq = density.fullQ(mu, logvar)
    tq.init_attr_classifiers(
        {a: logreg.LogRegParams(torch.from_numpy(heads[0][i]),
                                torch.tensor(heads[1][i]))
         for i, a in enumerate(("amp", "tox"))}, {"amp": 1, "tox": 0})
    key = jax.random.PRNGKey(2)
    jz, js, ja = jq.rejection_sample(key, 150)
    w = np.full(30, 1 / 30, np.float32)
    draws = _jax_rejection_draws(key, [w, mu, np.exp(logvar)], 150)
    tz, ts, ta = tq.rejection_sample(None, 150, draws=draws)
    assert sorted(ts) == sorted(js) == [
        "clfZ_amp=1", "clfZ_prob_accum", "clfZ_tox=0"]
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-5)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    a = tq.rejection_sample(torch.Generator().manual_seed(9), 40)
    b = tq.rejection_sample(torch.Generator().manual_seed(9), 40)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def _models(family, seed):
    def small(C):
        cfg = C.default_config()
        cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = D, 10, 8
        if family == "transformer":
            cfg.model.E_args.E_class = "transformer"
            cfg.model.G_args.G_class = "transformer"
        return cfg
    jm = j_build(small(JC).model, n_vocab=24, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(small(TC).model, n_vocab=24, max_seq_len=10)
    return jm, jp, tm, t_ck.params_from_jax(flat)


@pytest.mark.parametrize("family", ["gru", "transformer"])
def test_decode_from_z_matches_jax(family):
    """n 37 in chunks of 16 (the last padded from 5 rows to 16): the
    port's tokens and peptides equal the JAX package's, each chunk's c
    rebuilt from fold_in(key, s) and injected."""
    jm, jp, tm, tp = _models(family, 3 if family == "gru" else 4)
    n, chunk = 37, 16
    z = np.random.default_rng(7).standard_normal((n, D)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jvocab = j_load_vocab(VOCAB)
    dataset = types.SimpleNamespace(
        idx2sentences=jvocab.to_sentences_batch)
    want = j_pipeline.decode_from_z(z, jm, jp, dataset, key=key, chunk=chunk)
    cs = []
    for s in range(0, n, chunk):
        kc = jax.random.split(jax.random.fold_in(key, s), 3)[1]
        cs.append(torch.from_numpy(np.array(jm.sample_c_prior(kc, chunk))))
    got = pipeline.decode_from_z(z, tm, tp, load_vocab(VOCAB), chunk=chunk,
                                 cs=cs)
    assert got == list(want)
    assert len(set(got)) > 1
    # the tokens under the same c, and a generator's c repeats with its
    # seed
    tokens, scores = pipeline.decode_top1(z, tm, tp, chunk=chunk, cs=cs)
    assert tokens.shape == (n, 11) and scores.shape == (n,)
    assert load_vocab(VOCAB).to_sentences_batch(
        tokens, print_special_tokens=False) == got
    a = pipeline.decode_top1(z, tm, tp, torch.Generator().manual_seed(1),
                             chunk=chunk)
    b = pipeline.decode_top1(z, tm, tp, torch.Generator().manual_seed(1),
                             chunk=chunk)
    np.testing.assert_array_equal(a[0], b[0])


def _frames(round_size, n_rounds, seed):
    """Round frames as one_sampling_round returns them, with duplicates
    within a round and across rounds."""
    rng = np.random.default_rng(seed)
    pool = ["K L", "A", "G W R", "L L K", "R R A", "C", "K K W", "A G",
            "W", "L K A G", ""] + [f"K {chr(65 + i)}" for i in range(20)]
    frames = []
    for _ in range(n_rounds):
        peps = [pool[i] for i in rng.integers(0, len(pool), round_size)]
        df = pd.DataFrame({
            "peptide": peps,
            "z": list(rng.standard_normal((round_size, 3)).astype(
                np.float16)),
            "accept_z": rng.random(round_size) < 0.4,
            "clfZ_prob_accum": rng.random(round_size).astype(np.float32),
            "clfZ_amp=1": rng.random(round_size).astype(np.float32),
            "clfZ_tox=0": rng.random(round_size).astype(np.float32)})
        frames.append(j_pipeline.compute_modlamp(df))
    return frames


def test_compute_modlamp_matches_jax():
    frame = _frames(40, 1, 2)[0][["peptide"]]
    pd.testing.assert_frame_equal(pipeline.compute_modlamp(frame),
                                  j_pipeline.compute_modlamp(frame))


def test_serial_loops_match_jax(monkeypatch, caplog):
    """Both packages' serial loops, fed the same round frames, end with
    equal frames after the same number of rounds, and log the same rates
    (the reference's denominators: unique samples kept)."""
    round_size, acc = 12, 9
    frames = _frames(round_size, 30, 4)
    for f in frames:
        f["accept"] = f["accept_z"]
    cfg, _, _ = TC.parse_and_finalize(["--hw.fused_rounds", "0"])
    args = types.SimpleNamespace(n_samples_acc=acc)
    calls = {"jax": 0, "torch": 0}

    def feeder(side):
        def one_round(*a, **k):
            calls[side] += 1
            return frames[calls[side] - 1].copy()
        return one_round

    monkeypatch.setattr(j_pipeline, "one_sampling_round", feeder("jax"))
    monkeypatch.setattr(pipeline, "one_sampling_round", feeder("torch"))
    logs = {}
    with caplog.at_level(logging.INFO, logger="GenerationAPI"):
        want = j_pipeline._serial_sampling_loop(
            cfg, args, None, None, None, None, jax.random.PRNGKey(0),
            round_size)
        logs["jax"] = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got, stats = pipeline._serial_sampling_loop(
            cfg, args, None, None, None, None, round_size, "cpu")
        logs["torch"] = [r.getMessage() for r in caplog.records]
    pd.testing.assert_frame_equal(got, want)
    assert logs["torch"] == logs["jax"]
    assert 1 < calls["torch"] == calls["jax"] < len(frames)
    assert len(got) >= acc and got["accept"].sum() >= acc
    assert got["peptide"].is_unique
    assert stats == {
        "rounds": calls["torch"], "rounds_launched": calls["torch"],
        "candidates": calls["torch"] * round_size,
        "accepted_z": int(sum(f["accept_z"].sum()
                              for f in frames[:calls["torch"]])),
        "unique": len(got), "unique_accepted": int(got["accept"].sum())}
    cols = pipeline._frame_columns(got)
    assert list(cols) == list(got.columns)
    assert cols["z"].shape == (len(got), 3) and cols["accept"].dtype == bool


def test_serial_pipeline_end_to_end(run_dir):  # noqa: F811
    """sample_pipeline --hw.fused_rounds 0 on the CPU: the sample files,
    unique peptides, at least n_samples_acc accepted."""
    import csv
    import glob
    stem = sample_pipeline.main(FLAGS + ["--savepath_toplevel", run_dir,
                                         "--device", "cpu",
                                         "--hw.fused_rounds", "0",
                                         "--samples_outfn_prefix", "serial"])
    for ext in (".plain.txt", ".csv", ".pkl"):
        assert os.path.exists(stem + ext), ext
    assert len(glob.glob(stem + ".accepted.*.csv")) == 1
    with open(stem + ".csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    peps = [r["peptide"] for r in rows]
    assert len(peps) == len(set(peps))
    assert sum(r["accept"] == "True" for r in rows) >= 20
