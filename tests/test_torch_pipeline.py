"""The port's CLaSS pipeline end to end on the CPU, on a tiny run dir
shared with the JAX package: a JAX-saved checkpoint, the amp vocab and
states dumps in the H5_SETS layout."""

import csv
import glob
import os
import shutil

import h5py
import jax
import numpy as np
import pytest

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch import sample_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITER = 7
FLAGS = ["--model.z_dim", "12", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "8", "--max_seq_len", "10",
         "--vae.n_iter", str(N_ITER), "--runname", "tiny",
         "--datapath", os.path.join(REPO, "data"),
         "--n_samples_per_round", "300", "--n_samples_acc", "20",
         "--Q_n_components", "4"]


def _write_states(path, rng, n, z_dim):
    mu = 0.5 * rng.standard_normal((n, z_dim))
    label = -np.ones((n, 6), np.int64)
    label[:, 0] = (mu[:, 0] + 0.3 * rng.standard_normal(n)) > 0
    label[:, 1] = (mu[:, 1] + 0.3 * rng.standard_normal(n)) > 0
    rows = {"src": np.ones((n, 10), np.int64),
            "z": mu.astype(np.float16), "mu": mu.astype(np.float16),
            "logvar": np.full((n, z_dim), -1.5, np.float16),
            "label": label, "split": np.zeros((n, 1), np.int64)}
    with h5py.File(path, "w") as f:
        for k, v in rows.items():
            f.create_dataset(k, data=v)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    top = str(tmp_path_factory.mktemp("torch_pipeline"))
    save = os.path.join(top, "tiny")
    os.makedirs(save)
    shutil.copy(os.path.join(REPO, "data", "amp", "vocab.dict"),
                os.path.join(save, "vocab.dict"))
    cfg = JC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = 12, 10, 8
    model = j_build(cfg.model, n_vocab=24, max_seq_len=10)
    j_ck.save(os.path.join(save, f"model_{N_ITER}.npz"),
              {"params": model.init_params(jax.random.PRNGKey(3))})
    rng = np.random.default_rng(0)
    for split, n in (("train", 400), ("test", 100)):
        _write_states(os.path.join(save, f"states_{split}_{N_ITER}.h5"),
                      rng, n, 12)
    return top


def _header(path):
    with open(path, newline="") as fh:
        return next(csv.reader(fh))


def test_port_pipeline_end_to_end(run_dir):
    stem = sample_pipeline.main(FLAGS + ["--savepath_toplevel", run_dir,
                                         "--device", "cpu"])
    for ext in (".plain.txt", ".csv", ".pkl"):
        assert os.path.exists(stem + ext), ext
    acc = glob.glob(stem + ".accepted.*.csv")
    assert len(acc) == 1
    assert int(acc[0].split(".accepted.")[1].split(".")[0]) >= 20
    with open(stem + ".csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    peps = [r["peptide"] for r in rows]
    assert len(peps) == len(set(peps))
    assert sum(r["accept"] == "True" for r in rows) >= 20
    with open(stem + ".plain.txt") as fh:
        assert fh.read().split("\n") == peps

    # the same run dir through the JAX pipeline: the same columns
    j_args = [("--QClass", dict(default="mogQ")),
              ("--Q_n_components", dict(type=int, default=100)),
              ("--Q_covariance_type", dict(default="diag")),
              ("--n_samples_per_round", dict(type=int, default=5000)),
              ("--n_samples_acc", dict(type=int, default=100)),
              ("--samples_outfn_prefix", dict(default="jax_samples")),
              ("--Q_select_amppos", dict(type=int, default=0)),
              ("--Q_from_full_dataloader",
               dict(action="store_true", default=False))]
    cfg, args, _ = JC.parse_and_finalize(
        FLAGS + ["--savepath_toplevel", run_dir], extra_args=j_args)
    j_stem = j_pipeline.run(cfg, args)
    assert _header(stem + ".csv") == _header(j_stem + ".csv")
    j_acc = glob.glob(j_stem + ".accepted.*.csv")
    assert _header(acc[0]) == _header(j_acc[0])


def test_slice_limits_raise(run_dir):
    for extra in (["--hw.fused_rounds", "0"], ["--hw.dp", "2"],
                  ["--Q_from_full_dataloader"]):
        with pytest.raises(NotImplementedError):
            sample_pipeline.main(FLAGS + ["--savepath_toplevel", run_dir,
                                          "--device", "cpu"] + extra)


def test_beam_canary_raises_on_the_kernel_route():
    """Below the floor on a CUDA device (the kernel's route) the canary
    raises (it never switches arms quietly); on the CPU (the plain
    version), or on small rounds, low uniqueness is the model's own and
    passes. The check reads only the device, so it runs here."""
    cfg, _, _ = TC.parse_and_finalize([])
    assert pipeline.beam_canary_check(cfg, "cuda", 5000, 1000) is False
    assert pipeline.beam_canary_check(cfg, "cuda", 100, 1) is False
    with pytest.raises(pipeline.BeamCanaryError):
        pipeline.beam_canary_check(cfg, "cuda", 5000, 10, context="r1")
    assert pipeline.beam_canary_check(cfg, "cpu", 5000, 10) is False
    off, _, _ = TC.parse_and_finalize(["--hw.beam_canary_floor", "0"])
    assert pipeline.beam_canary_check(off, "cuda", 5000, 10) is False
