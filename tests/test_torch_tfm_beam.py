"""The port's transformer beam (``beam_search`` on CPU tensors, which runs
the plain version of the B3 kernel, ``ops/tfm_beam_kernel.py``) against
the JAX package's on the same parameters and z/c:

(a) the JAX XLA arm (``set_pallas_beam(False)``);
(b) the JAX Pallas kernel in interpret mode (``set_pallas_beam(True)``),
    run as ``tests/test_pallas_tfm_beam.py`` runs it.

Hypotheses token-equal; scores within rtol/atol 1e-5 (the emb -> in-proj
fold regroups float sums, as the JAX package's own kernel test states).
B 19 crosses the JAX kernel's fp32 tile of 16 sentences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import beam as j_beam
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import beam as t_beam
from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

B = 19
CASES = [(0, 5, 3), (1, 4, 1), (2, 3, 3)]

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one CPU thread for the module: with its default threads
    under a parallel run's workers the cores are oversubscribed (a round of
    this file ran 10-20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _small(C):
    cfg = C.default_config()
    cfg.model.E_args.E_class = "transformer"
    cfg.model.G_args.G_class = "transformer"
    cfg.model.z_dim, cfg.model.emb_dim = 12, 10
    return cfg


@pytest.fixture(scope="module")
def models():
    jm = j_build(_small(JC).model, n_vocab=13, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(42))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(_small(TC).model, n_vocab=13, max_seq_len=10)
    return jm, jp, tm, t_ck.params_from_jax(flat)


def _zc(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, 12)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    return z, c


def _jax_beam(jm, jp, z, c, K, n_best, min_length, pallas):
    jax.clear_caches()
    j_beam.set_pallas_beam(pallas)
    try:
        h, s = j_beam.beam_search(jm, jp, jnp.asarray(z), jnp.asarray(c),
                                  beam_size=K, n_best=n_best,
                                  min_length=min_length)
        return np.asarray(h), np.asarray(s)
    finally:
        j_beam.set_pallas_beam(None)
        jax.clear_caches()


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("seed,K,n_best", CASES)
@pytest.mark.parametrize("min_length", [1, 4])
def test_beam_matches_jax(models, seed, K, n_best, min_length, pallas):
    jm, jp, tm, tp = models
    z, c = _zc(seed)
    h_ref, s_ref = _jax_beam(jm, jp, z, c, K, n_best, min_length, pallas)
    h, s = t_beam.beam_search(tm, tp, torch.from_numpy(z),
                              torch.from_numpy(c), beam_size=K,
                              n_best=n_best, min_length=min_length)
    np.testing.assert_array_equal(h.numpy(), h_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=1e-5)


def test_plain_route_and_kernel_route_agree_on_cpu(models):
    """On CPU tensors the kernel's route runs its plain version: plain=True
    gives the same hypotheses; the launch counter stays at 0."""
    _, _, tm, tp = models
    z, c = map(torch.from_numpy, _zc(3))
    before = tfm_beam_kernel.beam_scan_tfm.launches
    outs = [t_beam.beam_search(tm, tp, z, c, beam_size=5, n_best=1,
                               plain=p) for p in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert tfm_beam_kernel.beam_scan_tfm.launches == before


def test_applicability_gate():
    """The JAX kernel's scope, fp32 and bf16 (mirrors
    tests/test_pallas_tfm_beam.py's gate test)."""
    cfg = _small(TC)
    model = t_build(cfg.model, n_vocab=26, max_seq_len=25)
    assert tfm_beam_kernel.applicable(model, 5, torch.float32)
    assert tfm_beam_kernel.applicable(model, 5, torch.bfloat16)
    assert not tfm_beam_kernel.applicable(model, 5, torch.float16)
    assert not tfm_beam_kernel.applicable(model, 1, torch.float32)   # K<=1
    assert not tfm_beam_kernel.applicable(model, 25, torch.float32)  # K>V-2
    assert not tfm_beam_kernel.applicable(model, 11, torch.float32)  # T*K
    # the GRU family is the other kernel's scope
    gru = t_build(TC.default_config().model, n_vocab=26, max_seq_len=25)
    assert not tfm_beam_kernel.applicable(gru, 5, torch.float32)
    for key, val in (("d_model", 64), ("d_ff", 200), ("n_heads", 3)):
        cfg2 = _small(TC)
        cfg2.model.G_args.T_args[key] = val
        m2 = t_build(cfg2.model, n_vocab=26, max_seq_len=25)
        assert not tfm_beam_kernel.applicable(m2, 5, torch.float32), key
    assert not tfm_beam_kernel.applicable(
        t_build(cfg.model, n_vocab=128, max_seq_len=25), 5, torch.float32)
    assert not tfm_beam_kernel.applicable(
        t_build(cfg.model, n_vocab=26, max_seq_len=32), 5, torch.float32)


def test_kernel_route_takes_cpu_or_cuda_tensors_only():
    """The wrapper runs the plain version only for CPU tensors: any other
    device that is not CUDA raises before any work."""
    meta = torch.device("meta")
    rows = [torch.empty((4, 128), device=meta)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfm_beam_kernel.beam_scan_tfm(
            torch.empty((13, 128), device=meta), None, [], None, None, None,
            None, rows, rows, T=10, K=5, V=13, S=11, H=4, F=256,
            min_length=1, n_best=1)


@pytest.mark.parametrize("Kd,N", [(128, 384), (128, 128), (256, 128),
                                  (128, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_tiles_unpack_to_the_matrix(Kd, N, dtype):
    """The kernel's pre-tiled products' matrices hold the checkpoint's
    values: untiling gives the matrix back, and the value lane (rg, cg)
    of warp w reads at 4-k step kk of a 128-column chunk is
    w[4kk + kq, 128n + 16w + 2cg + c] (csrc/tfm_beam.cu:gemm)."""
    g = torch.Generator().manual_seed(Kd + N)
    w = torch.randn((Kd, N), generator=g)
    tiles = tfm_beam_kernel.weight_tiles(w, dtype)
    assert tiles.dtype == dtype and tiles.numel() == Kd * N
    assert torch.equal(tfm_beam_kernel.weight_untile(tiles, Kd, N),
                       w.to(dtype))
    t = tiles.reshape(N // 128, 8, Kd // 4, 8, 2, 4)
    for n, wp, kk, cg, c, kq in ((0, 0, 0, 0, 0, 0),
                                 (N // 128 - 1, 7, Kd // 4 - 1, 7, 1, 3),
                                 (0, 3, 5, 2, 1, 2)):
        assert t[n, wp, kk, cg, c, kq] == w[4 * kk + kq,
                                            128 * n + 16 * wp + 2 * cg + c
                                            ].to(dtype)


@pytest.mark.parametrize("F", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_layers_unpacks_to_the_leaves(F, dtype):
    """pack_layers: per layer the four products' matrices tiled, then
    their biases, at the kernel's layer_off offsets (in elements); the
    LayerNorm pack ln1 g, b, ln2 g, b per layer in f32."""
    D = 128
    g = torch.Generator().manual_seed(F)
    shapes = {"qkv": (D, 3 * D), "attn_out": (D, D), "ff1": (D, F),
              "ff2": (F, D)}
    layers = [{blk: {"w": torch.randn(s, generator=g),
                     "b": torch.randn((s[1],), generator=g)}
               for blk, s in shapes.items()} for _ in range(2)]
    for lp in layers:
        for ln in ("ln1", "ln2"):
            lp[ln] = {"g": torch.randn((D,), generator=g),
                      "b": torch.randn((D,), generator=g)}
    wpack, lnpack = tfm_beam_kernel.pack_layers(layers, dtype)
    size = sum(a * b for a, b in shapes.values()) + 3 * D + D + F + D
    assert wpack.dtype == dtype and wpack.numel() == 2 * size
    assert lnpack.dtype == torch.float32 and lnpack.numel() == 2 * 4 * D
    for l, lp in enumerate(layers):
        off = l * size
        for blk, (kd, n) in shapes.items():
            got = tfm_beam_kernel.weight_untile(wpack[off:off + kd * n], kd,
                                                n)
            assert torch.equal(got, lp[blk]["w"].to(dtype)), blk
            off += kd * n
        for blk, (_, n) in shapes.items():
            assert torch.equal(wpack[off:off + n], lp[blk]["b"].to(dtype))
            off += n
        ln = torch.cat([lp[b][x] for b, x in tfm_beam_kernel._LN_LEAVES])
        assert torch.equal(lnpack[l * 4 * D:(l + 1) * 4 * D], ln)


def test_stamp_phases_name_the_kernel_phases():
    """The phase names the stamp report uses, in the kernel's enum order
    (embed, the eight per-layer phases, head, selection, reorder)."""
    assert tfm_beam_kernel.STAMP_PHASES == (
        "embed", "ln1", "qkv", "kv write", "attention", "out", "ln2", "ff1",
        "ff2", "final ln + head", "selection", "reorder")
