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
