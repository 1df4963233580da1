"""The port's latent states dump and index against the JAX package's
``vis/build_index.py`` on the CPU: the same checkpoint (JAX-saved, small
widths) and the amp corpus, 300 rows a split.

The dump: src, label and split equal, mu, logvar and z equal after
float16 storage or one float16 ulp apart where the two encoders' f32
values straddle a rounding boundary (the share of such entries is
printed, ``-s``, and asserted below 0.5%). Dumps and indexes cross both
ways; with h5py hidden (as on the H100 machine) the port writes and
reads the ``.npz`` alone."""

import os
import shutil
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import pipeline as j_pipeline
from controlled_peptide_generation_tpu.api import load_vocab as j_load_vocab
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.vis import build_index as j_bi

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch.api import (load_trained_model,
                                                         load_vocab)
from controlled_peptide_generation_tpu_torch.vis import build_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ITER = 7
N_ROWS = 300
SPLITS = ("train", "val", "test")
FLAGS = ["--model.z_dim", "12", "--model.emb_dim", "10",
         "--model.E_args.h_dim", "8", "--max_seq_len", "10",
         "--vae.n_iter", str(N_ITER), "--runname", "tiny",
         "--datapath", os.path.join(REPO, "data")]
MAX_ULP_SHARE = 0.005


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One JAX-saved checkpoint; the JAX package's dump of it in jax/,
    the port's in port/ (encoded in chunks of 128 rows, so a split spans
    three encoder calls, the last one short)."""
    top = str(tmp_path_factory.mktemp("build_index"))
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = os.path.join(top, side, "tiny")
        os.makedirs(dirs[side])
        shutil.copy(os.path.join(REPO, "data", "amp", "vocab.dict"),
                    os.path.join(dirs[side], "vocab.dict"))
    jcfg, _, _ = JC.parse_and_finalize(
        FLAGS + ["--savepath_toplevel", os.path.join(top, "jax")])
    jm = j_build(jcfg.model, n_vocab=24, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(5))
    model_path = os.path.join(dirs["jax"], f"model_{N_ITER}.npz")
    j_ck.save(model_path, {"params": jp})
    spec = JC.dataset_spec(jcfg)
    spec.pop("synthetic", None)
    jl = j_pipeline.AttributeDataLoader(mbsize=jcfg.vae.batch_size,
                                        max_seq_len=jcfg.max_seq_len, **spec)
    j_bi.extract_from_dataset(
        jm, jp, j_load_vocab(os.path.join(dirs["jax"], "vocab.dict")), jcfg,
        jl, dirs["jax"], N_ITER, max_examples=N_ROWS)

    tcfg, _, _ = TC.parse_and_finalize(
        FLAGS + ["--savepath_toplevel", os.path.join(top, "port")])
    tm, tp = load_trained_model(model_path, 24, tcfg, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(build_index, "CHUNK", 128)
    try:
        paths, seconds = build_index.extract_from_dataset(
            tm, tp, load_vocab(os.path.join(dirs["port"], "vocab.dict")),
            tcfg, pipeline.load_dataloader(tcfg), dirs["port"], N_ITER,
            max_examples=N_ROWS)
    finally:
        mp.undo()
    assert set(paths) == set(seconds) == set(SPLITS)
    return {"dirs": dirs, "tcfg": tcfg, "model": tm, "params": tp}


def _path(d, split):
    return build_index.states_path(d, split, N_ITER)


def _f16_ulps(a, b):
    """|a - b| in float16 ulps of the larger magnitude (a, b float16)."""
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
    return np.abs(a32 - b32) / ulp


@pytest.mark.parametrize("split", SPLITS)
def test_dump_matches_jax(dumps, split):
    """The port's .npz against the JAX package's .h5 of the same rows:
    src, label and split exactly, the float16 arrays within one ulp."""
    want = j_bi.read_states(_path(dumps["dirs"]["jax"], split))
    with np.load(build_index.npz_path(
            _path(dumps["dirs"]["port"], split))) as data:
        got = {k: data[k] for k in build_index.H5_SETS}
    for k in build_index.H5_SETS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    assert got["src"].shape == (N_ROWS, 10)
    for k in ("src", "label", "split"):
        np.testing.assert_array_equal(got[k], want[k])
    assert np.all(got["split"] == build_index.SPLIT_ENCODING[split])
    assert (got["label"] == -1).any()
    differ = 0
    for k in ("mu", "logvar", "z"):
        ulps = _f16_ulps(got[k], want[k])
        assert ulps.max() <= 1.0, k
        differ += int((ulps > 0).sum())
    np.testing.assert_array_equal(got["z"], got["mu"])
    share = differ / (3 * got["mu"].size)
    print(f"{split}: share of the float16 entries one ulp apart {share:.6f}")
    assert share < MAX_ULP_SHARE


def _h5_layout(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].dtype, f[k].shape, f[k].maxshape, f[k].compression,
                    f[k].compression_opts) for k in build_index.H5_SETS}


def test_dumps_cross_both_ways(dumps):
    """The port reads the JAX package's .h5; the JAX package reads the
    port's .h5 (same schema: dtypes, maxshapes, gzip 9); the port's .npz
    and .h5 hold identical arrays."""
    for split in SPLITS:
        j_path = _path(dumps["dirs"]["jax"], split)
        t_path = _path(dumps["dirs"]["port"], split)
        assert not os.path.exists(build_index.npz_path(j_path))
        from_jax = build_index.read_states(j_path)
        for k, v in j_bi.read_states(j_path).items():
            np.testing.assert_array_equal(from_jax[k], v)
        assert _h5_layout(t_path) == _h5_layout(j_path)
        port_h5 = j_bi.read_states(t_path)
        with np.load(build_index.npz_path(t_path)) as data:
            for k in build_index.H5_SETS:
                assert data[k].dtype == port_h5[k].dtype
                np.testing.assert_array_equal(data[k], port_h5[k])


def test_dump_without_h5py(dumps, tmp_path, monkeypatch):
    """With h5py hidden the port writes the .npz alone and reads it back
    (the same arrays as the dump with h5py); a dump only in .h5 then
    raises FileNotFoundError naming both paths and static_eval --long."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(build_index, "CHUNK", 128)
    out = str(tmp_path)
    build_index.extract_from_dataset(
        dumps["model"], dumps["params"],
        load_vocab(os.path.join(dumps["dirs"]["port"], "vocab.dict")),
        dumps["tcfg"], pipeline.load_dataloader(dumps["tcfg"]), out, N_ITER,
        max_examples=N_ROWS)
    assert sorted(os.listdir(out)) == sorted(
        f"states_{s}_{N_ITER}.npz" for s in SPLITS)
    for split in SPLITS:
        assert build_index.readable(_path(out, split))
        got = build_index.read_states(_path(out, split))
        with np.load(build_index.npz_path(
                _path(dumps["dirs"]["port"], split))) as data:
            for k in build_index.H5_SETS:
                np.testing.assert_array_equal(got[k], data[k])
    j_path = _path(dumps["dirs"]["jax"], "train")
    assert not build_index.readable(j_path)
    with pytest.raises(FileNotFoundError) as err:
        build_index.read_states(j_path)
    msg = str(err.value)
    assert j_path in msg and build_index.npz_path(j_path) in msg
    assert "static_eval --long" in msg


def test_load_states_reads_the_dump(dumps, monkeypatch):
    """pipeline.load_states reads the port's dump, with or without h5py,
    and raises naming static_eval --long where there is none."""
    cfg = dumps["tcfg"]
    with_h5 = pipeline.load_states(cfg, splits=SPLITS)
    monkeypatch.setitem(sys.modules, "h5py", None)
    without = pipeline.load_states(cfg, splits=SPLITS)
    for split in SPLITS:
        for k in build_index.H5_SETS:
            np.testing.assert_array_equal(with_h5[split][k],
                                          without[split][k])
    cfg.vae.n_iter = N_ITER + 1
    try:
        with pytest.raises(FileNotFoundError, match="static_eval --long"):
            pipeline.load_states(cfg)
    finally:
        cfg.vae.n_iter = N_ITER


def _tie_free(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def test_mips_topk_matches_jax():
    rng = np.random.default_rng(11)
    q, z = _tie_free(rng, 17, 12), _tie_free(rng, 300, 12)
    want_s, want_i = j_bi.mips_topk(jnp.asarray(q), jnp.asarray(z), k=10)
    got_s, got_i = build_index.mips_topk(torch.from_numpy(q),
                                         torch.from_numpy(z), k=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)


def test_latent_index_crosses_both_ways(dumps, tmp_path):
    """An index saved by either package loads in the other with the same
    z and search results; the port's from_states reads the dump's z."""
    rng = np.random.default_rng(12)
    q = _tie_free(rng, 9, 12)
    z = _tie_free(rng, 200, 12)
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_bi.LatentIndex(z).save(j_path)
    build_index.LatentIndex(z).save(t_path)
    for path in (j_path, t_path):
        j_idx, t_idx = j_bi.LatentIndex.load(path), \
            build_index.LatentIndex.load(path)
        np.testing.assert_array_equal(t_idx.z.numpy(), np.asarray(j_idx.z))
        (js, ji), (ts, ti) = j_idx.search(q, k=5), t_idx.search(q, k=5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5)
    train = _path(dumps["dirs"]["port"], "train")
    idx = build_index.LatentIndex.from_states(train)
    np.testing.assert_array_equal(
        idx.z.numpy(), build_index.read_states(train)["z"].astype(np.float32))
