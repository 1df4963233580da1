"""``static_eval --long`` of the model's options against the JAX package
on the CPU: a skip-connection model, a posterior flow model and a deconv
model, each at small widths (z 12, emb 10, encoder H 8, T 25, 4 deconv
filters) on one JAX-saved checkpoint and the amp corpus, 200 rows a
split.

The JAX side writes what its ``static_eval.run_long_analysis`` writes
before its diagnostics: the states dump (``vis/build_index.py
extract_from_dataset``) and the latent index (``LatentIndex.from_states``
of the train dump). The port runs its own ``static_eval.main --long
--device cpu`` on a run dir holding the same checkpoint (the dump, the
index, the diagnostics and the battery). The dumps agree as
``tests/test_torch_build_index.py`` holds the default model's: src, label
and split equal, mu, logvar and z within one float16 ulp (two f32 encoders'
values straddling a rounding boundary), on under 0.5% of the entries; the
two indexes hold the same rows within that ulp, and their top-5 searches
of the same queries give the same scores (rtol 2e-3: the ulp above), the
port's rows scoring as JAX's under JAX's z (an untrained encoder puts rows
close together: a near-tie may pick another row)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.api import load_vocab as j_load_vocab
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.vis import build_index as j_bi

from controlled_peptide_generation_tpu_torch import static_eval
from controlled_peptide_generation_tpu_torch.vis import build_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITER = 3
N_ROWS = 200
SPLITS = ("train", "val", "test")
SMALL = ["--model.z_dim", "12", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "8", "--max_seq_len", "25",
         "--model.G_args.deconv_args.num_filters", "4",
         "--vae.n_iter", str(N_ITER), "--runname", "opt",
         "--datapath", os.path.join(REPO, "data")]
OPTIONS = {
    "skip": ["--model.G_args.GRU_args.skip_connections", "1"],
    "flow": ["--model.flow", "3", "--model.flow_type", "alternating",
             "--model.flow_mode", "posterior"],
    "deconv": ["--model.G_args.G_class", "deconv"]}
MAX_ULP_SHARE = 0.005


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f16_ulps(a, b):
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
    return np.abs(a32 - b32) / ulp


@pytest.mark.parametrize("option", list(OPTIONS))
def test_static_eval_long_matches_jax(option, tmp_path, monkeypatch,
                                      capsys):
    flags = SMALL + OPTIONS[option]
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = os.path.join(str(tmp_path), side, "opt")
        os.makedirs(dirs[side])
        shutil.copy(os.path.join(REPO, "data", "amp", "vocab.dict"),
                    os.path.join(dirs[side], "vocab.dict"))
    jcfg, _, _ = JC.parse_and_finalize(
        flags + ["--savepath_toplevel", os.path.join(str(tmp_path), "jax")])
    jm = j_build(jcfg.model, n_vocab=24, max_seq_len=25)
    jp = jm.init_params(jax.random.PRNGKey(17))
    for side in ("jax", "port"):
        j_ck.save(os.path.join(dirs[side], f"model_{N_ITER}.npz"),
                  {"params": jp})
    spec = JC.dataset_spec(jcfg)
    spec.pop("synthetic", None)
    jl = j_pipeline.AttributeDataLoader(mbsize=jcfg.vae.batch_size,
                                        max_seq_len=jcfg.max_seq_len, **spec)
    j_bi.extract_from_dataset(
        jm, jp, j_load_vocab(os.path.join(dirs["jax"], "vocab.dict")), jcfg,
        jl, dirs["jax"], N_ITER, max_examples=N_ROWS)
    j_index = j_bi.index_path(dirs["jax"], N_ITER)
    j_bi.LatentIndex.from_states(
        j_bi.states_path(dirs["jax"], "train", N_ITER)).save(j_index)

    monkeypatch.setattr(static_eval, "MAX_EXAMPLES", N_ROWS)
    summary = static_eval.main(flags + [
        "--savepath_toplevel", os.path.join(str(tmp_path), "port"), "--long",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "#### reco of" in out and " - hyp 2: " in out

    differ = total = 0
    for split in SPLITS:
        want = j_bi.read_states(j_bi.states_path(dirs["jax"], split, N_ITER))
        path = summary["states"][split]
        assert path == build_index.states_path(dirs["port"], split, N_ITER)
        with np.load(build_index.npz_path(path)) as data:
            got = {k: data[k] for k in build_index.H5_SETS}
        for k in build_index.H5_SETS:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
        assert got["mu"].shape == (N_ROWS, 12)
        for k in ("src", "label", "split"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("mu", "logvar", "z"):
            ulps = _f16_ulps(got[k], want[k])
            assert ulps.max() <= 1.0, (split, k)
            differ += int((ulps > 0).sum())
            total += ulps.size
    assert differ / total < MAX_ULP_SHARE

    assert summary["index"] == build_index.index_path(dirs["port"], N_ITER)
    t_idx = build_index.LatentIndex.load(summary["index"])
    j_idx = j_bi.LatentIndex.load(j_index)
    tz, jz = t_idx.z.numpy(), np.asarray(j_idx.z)
    assert tz.shape == jz.shape == (N_ROWS, 12)
    assert _f16_ulps(tz.astype(np.float16), jz.astype(np.float16)).max() <= 1
    q = np.random.default_rng(3).standard_normal((6, 12)).astype(np.float32)
    (ts, ti), (js, ji) = t_idx.search(q, k=5), j_idx.search(q, k=5)
    np.testing.assert_allclose(ts, js, rtol=2e-3, atol=2e-3)
    # an untrained encoder puts rows close together, so near-ties may take
    # other rows: the port's rows score as the JAX top-5 under JAX's z
    rescored = np.einsum("qd,qkd->qk", q, jz[np.asarray(ti)])
    np.testing.assert_allclose(rescored, js, rtol=2e-3, atol=2e-3)
