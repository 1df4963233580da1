"""The port's beam against the JAX package's, on the CPU.

(a) The plain ``beam_scan_gru_reference`` against the JAX Pallas kernel
    run in interpret mode, on the same numpy inputs: token and pointer
    tapes, adv and fin equal exactly; scores to 1e-5 (the two sum in
    different orders).
(b) The port's ``beam_search`` (kernel route, which on CPU tensors is the
    plain version) against the JAX XLA scan (``set_pallas_beam(False)``):
    hypotheses equal exactly, scores to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import beam as j_beam
from controlled_peptide_generation_tpu.ops import pallas_beam
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import beam as t_beam
from controlled_peptide_generation_tpu_torch.ops import beam_kernel
from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

B = 37
CASES = [(K, n_best, min_length) for K in (3, 5) for n_best in (1, 3)
         for min_length in (1, 4) if n_best <= K]


def _small(C):
    cfg = C.default_config()
    cfg.model.z_dim = 12
    cfg.model.emb_dim = 10
    cfg.model.E_args.h_dim = 8
    return cfg


@pytest.fixture(scope="module")
def models():
    jm = j_build(_small(JC).model, n_vocab=13, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(42))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(_small(TC).model, n_vocab=13, max_seq_len=10)
    return jm, jp, tm, t_ck.params_from_jax(flat)


def _scan_inputs(seed, B, V, H):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    return (f(V, 3 * H), f(B, 3 * H), f(H, 3 * H), f(3 * H), f(H, V),
            f(V), f(B, H))


@pytest.mark.parametrize("K,n_best,min_length", CASES)
def test_reference_matches_pallas_interpret(K, n_best, min_length):
    V, H, T = 13, 14, 10
    ins = _scan_inputs(K * 100 + n_best * 10 + min_length, B, V, H)
    kw = dict(T=T, K=K, V=V, H=H, min_length=min_length, n_best=n_best)
    want = pallas_beam.beam_scan_gru(*map(jnp.asarray, ins), **kw,
                                     interpret=True)
    got = beam_kernel.beam_scan_gru_reference(*map(torch.from_numpy, ins),
                                              **kw)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    for name, w, g in zip(("ys", "ptr", "adv", "fin"),
                          (want[0], want[1], want[4], want[5]),
                          (got[0], got[1], got[4], got[5])):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


@pytest.mark.parametrize("K,n_best,min_length", CASES)
def test_beam_search_matches_jax_xla(models, K, n_best, min_length):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(7 + K + n_best + min_length)
    z = rng.standard_normal((B, jm.z_dim)).astype(np.float32)
    c = np.eye(jm.c_dim, dtype=np.float32)[rng.integers(0, 2, B)]
    jax.clear_caches()
    j_beam.set_pallas_beam(False)
    try:
        h_ref, s_ref = j_beam.beam_search(
            jm, jp, jnp.asarray(z), jnp.asarray(c), beam_size=K,
            n_best=n_best, min_length=min_length)
        h_ref, s_ref = np.asarray(h_ref), np.asarray(s_ref)
    finally:
        j_beam.set_pallas_beam(None)
        jax.clear_caches()
    h, s = t_beam.beam_search(tm, tp, torch.from_numpy(z),
                              torch.from_numpy(c), beam_size=K,
                              n_best=n_best, min_length=min_length)
    np.testing.assert_array_equal(h.numpy(), h_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-5)


def test_beam_routes(models):
    """On CPU tensors the kernel's route runs its plain version, and
    plain=True gives the same hypotheses; a model outside the kernel's
    scope still decodes on the CPU (the plain version takes any shape)."""
    _, _, tm, tp = models
    g = torch.Generator().manual_seed(0)
    z = torch.randn((9, tm.z_dim), generator=g)
    c = tm.sample_c_prior(g, 9)
    outs = [t_beam.beam_search(tm, tp, z, c, beam_size=5, n_best=1,
                               plain=p)[0] for p in (False, True)]
    assert torch.equal(outs[0], outs[1])
    wide = [t_beam.beam_search(tm, tp, z, c, beam_size=12, n_best=1,
                               plain=p)[0] for p in (False, True)]
    assert torch.equal(wide[0], wide[1])
    assert beam_kernel.applicable(tm, 5, torch.float32)
    assert not beam_kernel.applicable(tm, 12, torch.float32)
    assert not beam_kernel.applicable(tm, 5, torch.float16)


@pytest.mark.parametrize("H,V", [(102, 24), (14, 13), (127, 128), (1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_transposes_and_pads(H, V, dtype):
    """The GRU beam kernel's transposed weights (csrc/beam_gru.cu:make_geo):
    whT[g, j, k] = wh[k, g*H + j] and woT[v, k] = w_out[k, v], zeros
    elsewhere; NL = ceil(H/4) lanes of 4 units, rows padded to HL = 4 NL
    and to LDW = 4 x an odd number >= HL, so that the 16-byte loads of 8
    consecutive rows (a quarter-warp) fall on 8 distinct 16-byte bank
    groups; the head's columns padded to a multiple of 32."""
    g = torch.Generator().manual_seed(H * V)
    wh = torch.randn((H, 3 * H), generator=g).to(dtype)
    wo = torch.randn((H, V), generator=g).to(dtype)
    whT, woT = beam_kernel.weight_layout(wh, wo)
    NL = -(-H // 4)
    HL, LDW = 4 * NL, whT.shape[2]
    assert whT.shape == (3, HL, LDW) and woT.shape[1] == LDW
    assert LDW >= HL and LDW % 4 == 0 and (LDW // 4) % 2 == 1
    assert woT.shape[0] % 32 == 0 and woT.shape[0] >= V
    assert {(r * LDW // 4) % 8 for r in range(8)} == set(range(8))
    assert torch.equal(whT[:, :H, :H],
                       wh.reshape(H, 3, H).permute(1, 2, 0))
    assert torch.equal(woT[:V, :H], wo.T)
    assert whT[:, H:].abs().sum() == 0 and whT[:, :, H:].abs().sum() == 0
    assert woT[V:].abs().sum() == 0 and woT[:, H:].abs().sum() == 0


@pytest.mark.parametrize("H,V", [(102, 24), (14, 13), (127, 128), (1, 5)])
def test_mma_layout_transposes_and_pads_for_the_tensor_cores(H, V):
    """The bf16 kernel's tensor-core weights (csrc/beam_gru.cu:make_mgeo),
    bf16 in and out: whT[g, j, k] = wh[k, g*H + j] and woT[v, k] =
    w_out[k, v], zeros elsewhere; units and k padded to KP = 16 ceil(H/16),
    the vocabulary to 16 rows, rows LDK = KP + 8 long, so that ldmatrix's
    eight 16-byte row reads (rows LDK / 2 words apart) fall on 8 distinct
    16-byte bank groups."""
    g = torch.Generator().manual_seed(H * V)
    wh = torch.randn((H, 3 * H), generator=g).to(torch.bfloat16)
    wo = torch.randn((H, V), generator=g).to(torch.bfloat16)
    whT, woT = beam_kernel.mma_layout(wh, wo)
    KP = 16 * -(-H // 16)
    LDK = whT.shape[2]
    assert whT.dtype == woT.dtype == torch.bfloat16
    assert whT.shape == (3, KP, KP + 8) and woT.shape == (16 * -(-V // 16),
                                                          LDK)
    assert {(r * LDK // 2 // 4) % 8 for r in range(8)} == set(range(8))
    assert torch.equal(whT[:, :H, :H],
                       wh.reshape(H, 3, H).permute(1, 2, 0))
    assert torch.equal(woT[:V, :H], wo.T)
    assert whT[:, H:].abs().sum() == 0 and whT[:, :, H:].abs().sum() == 0
    assert woT[V:].abs().sum() == 0 and woT[:, H:].abs().sum() == 0


def test_read_stamps_splits_cycles_and_waves():
    """cuda_build.read_stamps on a stamp buffer as the kernels write it:
    [2] recorded block ids, per record [total cycles, phase cycles], then
    per block [start ns, end ns]; the blocks that start before the first
    one ends are the resident ones, and a block's wave is its start's rank
    over them."""
    n_ph = len(beam_kernel.STAMP_PHASES)
    recs = [[0, 1000, 500, 100, 300, 100], [4, 800, 400, 100, 200, 100]]
    # 5 blocks, 2 resident at once: waves 0, 0, 1, 1, 2
    times = [0, 10, 1, 11, 10, 20, 11, 21, 20, 30]
    buf = torch.tensor([0, 4] + recs[0][1:] + recs[1][1:] + times,
                       dtype=torch.int64)
    st = cuda_build.read_stamps(buf, beam_kernel.STAMP_PHASES, n_ph)
    assert (st["grid"], st["slots"], st["span_ns"]) == (5, 2, 30)
    assert st["waves"] == 2.5
    assert [(b["block"], b["wave"], b["cycles"]) for b in st["blocks"]] == [
        (0, 0, 1000), (4, 2, 800)]
    assert st["blocks"][0]["share"] == dict(zip(
        beam_kernel.STAMP_PHASES, (0.5, 0.1, 0.3, 0.1)))
    with pytest.raises(ValueError):
        cuda_build.read_stamps(buf, beam_kernel.STAMP_PHASES[:3], n_ph)


def test_beam_split_names_each_instantiation():
    """The beam modules' ptxas_report (cuda_build.beam_kernel_name) names
    the beam kernels' instantiations from ptxas' -v output, as
    tools/beam_split.py prints them: the type, production or stamp (the
    last template flag), B1's weights read through L2 (its first flag 0)
    and B3's products on the tensor cores (its first flag 1)."""
    from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
    pre = "_ZN44_GLOBAL__N__4128ba18_11_cu_75e952b915"
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{pre}{kern}I{typ}{flags}"
        f"EEvPKT_' for 'sm_90a'\n    0 bytes stack frame, {st} bytes spill "
        f"stores, {ld} bytes spill loads\nptxas info    : Used {regs} "
        f"registers, used 1 barriers"
        for kern, typ, flags, regs, st, ld in (
            ("beam_gru_mma_kernel", "13__nv_bfloat16", "Lb1ELb0E", 121, 0,
             0),
            ("beam_gru_mma_kernel", "13__nv_bfloat16", "Lb0ELb0E", 128, 40,
             108),
            ("beam_gru_kernel", "f", "Lb0ELb1E", 200, 4, 8),
            ("tfm_beam_kernel", "f", "Lb0ELb1E", 128, 32, 80),
            ("tfm_beam_kernel", "13__nv_bfloat16", "Lb1ELb0E", 128, 12, 12)))
    assert beam_kernel.ptxas_report(log) == tfm_beam_kernel.ptxas_report(
        log) == {
        "beam_gru_mma_kernel<bf16, production>": (121, 0, 0),
        "beam_gru_mma_kernel<bf16, production, weights via L2>": (128, 40,
                                                                  108),
        "beam_gru_kernel<f32, stamp, weights via L2>": (200, 4, 8),
        "tfm_beam_kernel<f32, stamp>": (128, 32, 80),
        "tfm_beam_kernel<bf16, production, tensor cores>": (128, 12, 12)}
