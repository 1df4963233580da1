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
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch import sample_pipeline
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)

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
        assert [line.strip() for line in fh.read().split("\n")] == peps

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


def test_sample_files_match_jax(tmp_path):
    """The same samples through both packages' save_samples: .plain.txt,
    .csv and .accepted.<n>.csv byte-equal (pandas writes both: the peptide
    column right-justified, the float32 score columns with pandas' own
    digits)."""
    import pandas as pd
    rng = np.random.default_rng(8)
    n = 9
    peps = ["K L", "K L L K A", "G", "W W R", "A", "L K K L L K A G W",
            "R R", "C", "G L"]
    samples = {"peptide": peps,
               "z": rng.standard_normal((n, 4)).astype(np.float16),
               "accept_z": rng.random(n) < 0.5}
    samples["accept_z"][:2] = True
    for k in ("clfZ_prob_accum", "clfZ_amp=1", "clfZ_tox=0"):
        samples[k] = rng.random(n).astype(np.float32)
    samples["clfZ_prob_accum"][0] = np.float32(1e-30)
    for k in ("H", "uH", "charge"):
        samples[k] = rng.standard_normal(n)
    samples["accept"] = samples["accept_z"].copy()
    # the JAX package's loop builds its frame so (pipeline.py:767-777)
    frame = pd.DataFrame({
        "peptide": peps, "z": list(samples["z"]),
        "accept_z": samples["accept_z"],
        **{k: samples[k] for k in ("clfZ_prob_accum", "clfZ_amp=1",
                                   "clfZ_tox=0", "H", "uH", "charge")}})
    frame["accept"] = frame["accept_z"]
    stems = []
    for d, save in (("torch", pipeline.save_samples),
                    ("jax", j_pipeline.save_samples)):
        os.makedirs(tmp_path / d)
        stems.append(save(samples if d == "torch" else frame,
                          str(tmp_path / d), "s"))
    n_acc = int(samples["accept"].sum())
    for ext in (".plain.txt", ".csv", f".accepted.{n_acc}.csv"):
        got, want = (open(st + ext, "rb").read() for st in stems)
        assert got == want, ext
    with open(stems[0] + ".plain.txt") as fh:
        assert fh.read().split("\n")[0] == "K L".rjust(max(map(len, peps)))


def test_slice_limits_raise(run_dir):
    # the serial loop (--hw.fused_rounds 0) runs: tests/test_torch_serial.py
    with pytest.raises(NotImplementedError, match="A9"):
        sample_pipeline.main(FLAGS + ["--savepath_toplevel", run_dir,
                                      "--device", "cpu", "--hw.dp", "2"])
    # the dataloader encodings select amp=1, as in the JAX package
    with pytest.raises(ValueError, match="Q_select_amppos"):
        sample_pipeline.main(FLAGS + ["--savepath_toplevel", run_dir,
                                      "--device", "cpu",
                                      "--Q_from_full_dataloader"])


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


TFM = ["--model.E_args.E_class", "transformer",
       "--model.G_args.G_class", "transformer"]


@pytest.fixture(scope="module")
def tfm_run_dir(tmp_path_factory):
    """A tiny transformer run dir: a JAX-saved checkpoint (list-index keys),
    the amp vocab and states dumps."""
    top = str(tmp_path_factory.mktemp("torch_pipeline_tfm"))
    save = os.path.join(top, "tiny")
    os.makedirs(save)
    shutil.copy(os.path.join(REPO, "data", "amp", "vocab.dict"),
                os.path.join(save, "vocab.dict"))
    cfg = JC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim = 12, 10
    cfg.model.E_args.E_class = "transformer"
    cfg.model.G_args.G_class = "transformer"
    model = j_build(cfg.model, n_vocab=24, max_seq_len=10)
    j_ck.save(os.path.join(save, f"model_{N_ITER}.npz"),
              {"params": model.init_params(jax.random.PRNGKey(4))})
    rng = np.random.default_rng(1)
    for split, n in (("train", 400), ("test", 100)):
        _write_states(os.path.join(save, f"states_{split}_{N_ITER}.h5"),
                      rng, n, 12)
    return top


@pytest.mark.parametrize("mode", ["all", "accepted"])
def test_transformer_pipeline_end_to_end(tfm_run_dir, mode):
    """The transformer family's CLaSS round through the CLI on the CPU
    (run -> run_from_states), in both decode modes."""
    stem = sample_pipeline.main(
        FLAGS + TFM + ["--savepath_toplevel", tfm_run_dir, "--device", "cpu",
                       "--hw.decode_mode", mode,
                       "--samples_outfn_prefix", f"tfm_{mode}"])
    with open(stem + ".csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    peps = [r["peptide"] for r in rows]
    assert len(peps) == len(set(peps))
    assert sum(r["accept"] == "True" for r in rows) >= 20
    assert len(glob.glob(stem + ".accepted.*.pkl")) == 1


def test_transformer_dispatch_budget_matches_jax():
    """The KV-cache lane budget and bytes per candidate agree with the JAX
    package's for both families and decode modes."""
    for fam, extra in (("gru", []), ("transformer", TFM)):
        for mode in ("all", "accepted"):
            argv = extra + ["--hw.decode_mode", mode,
                            "--hw.tfm_lane_budget_gb", "0.5"]
            tcfg, _, _ = TC.parse_and_finalize(argv)
            jcfg, _, _ = JC.parse_and_finalize(argv)
            jm = j_build(jcfg.model, n_vocab=24, max_seq_len=25)
            tm = t_build(tcfg.model, n_vocab=24, max_seq_len=25)
            assert (pipeline.transformer_dispatch_budget(tcfg, tm)
                    == j_pipeline.transformer_dispatch_budget(jcfg, jm)), (
                fam, mode)
            assert (pipeline.transformer_cache_bytes_per_candidate(tcfg, tm)
                    == j_pipeline.transformer_cache_bytes_per_candidate(
                        jcfg, jm)), (fam, mode)


def test_round_halves_on_device_oom(tfm_run_dir, monkeypatch):
    """A round that runs out of device memory halves and retries (the next
    rounds keep the smaller size); rounds_per_dispatch is clamped to the
    transformer lane budget; other errors propagate."""
    sizes = []
    real = pipeline.launch_round

    def launch(cfg, model, params, Q, n, gen):
        sizes.append(n)
        if n > 150:
            raise torch.cuda.OutOfMemoryError("test: out of memory")
        return real(cfg, model, params, Q, n, gen)

    monkeypatch.setattr(pipeline, "launch_round", launch)
    argv = FLAGS + TFM + ["--savepath_toplevel", tfm_run_dir,
                          "--device", "cpu", "--hw.rounds_per_dispatch", "4",
                          "--hw.tfm_lane_budget_gb", "0.001",
                          "--samples_outfn_prefix", "tfm_oom"]
    sample_pipeline.main(argv)
    # budget 0.001 GB / (6 x 112,640 B) = 1 candidate -> rpd 4 -> 1;
    # then 300 -> 150 on the out-of-memory error
    assert sizes[:2] == [300, 150] and set(sizes[2:]) <= {150}

    def broken(*a, **k):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(pipeline, "launch_round", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        sample_pipeline.main(argv)


@pytest.mark.parametrize("family", ["gru", "transformer"])
def test_dataloader_encodings_match_jax(family, request):
    """get_encodings_from_dataloader on the same checkpoint and rows as the
    JAX package's (which encodes through forward(q_c="classifier",
    sample_z="max", train=False); mu and logvar do not depend on c, so the
    port calls encode(train=False)): the same rows in the same order, mu
    and logvar within 1e-5."""
    from controlled_peptide_generation_tpu_torch.api import load_trained_model
    tfm = family == "transformer"
    top = request.getfixturevalue("tfm_run_dir" if tfm else "run_dir")
    flags = (FLAGS[:FLAGS.index("--n_samples_per_round")]
             + (TFM if tfm else []) + ["--savepath_toplevel", top])
    jcfg, _, _ = JC.parse_and_finalize(flags)
    jm = j_build(jcfg.model, n_vocab=24, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(4 if tfm else 3))
    spec = JC.dataset_spec(jcfg)
    spec.pop("synthetic", None)
    jl = j_pipeline.AttributeDataLoader(mbsize=jcfg.vae.batch_size,
                                        max_seq_len=jcfg.max_seq_len, **spec)
    want = j_pipeline.get_encodings_from_dataloader(
        jcfg, {"amp": 1}, "train,val", jm, jp, jl)
    tcfg, _, _ = TC.parse_and_finalize(flags)
    tm, tp = load_trained_model(
        os.path.join(top, "tiny", f"model_{N_ITER}.npz"), 24, tcfg,
        device="cpu")
    got = pipeline.get_encodings_from_dataloader(
        tcfg, {"amp": 1}, "train,val", tm, tp, pipeline.load_dataloader(tcfg))
    assert got[0].shape == want[0].shape and got[0].shape[0] > 10
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_pipeline_fits_Q_on_the_dataloader(run_dir):
    """--Q_from_full_dataloader --Q_select_amppos 1 end to end on the CPU:
    Q from the encodings of the dataset's amp-positive train and val rows,
    the eval points and heads from the states, samples written."""
    stem = sample_pipeline.main(
        FLAGS + ["--savepath_toplevel", run_dir, "--device", "cpu",
                 "--Q_from_full_dataloader", "--Q_select_amppos", "1",
                 "--samples_outfn_prefix", "from_dataloader"])
    with open(stem + ".csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    peps = [r["peptide"] for r in rows]
    assert len(peps) == len(set(peps))
    assert sum(r["accept"] == "True" for r in rows) >= 20
