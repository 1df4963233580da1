"""The port's bf16 CLaSS decode against the JAX package's on the CPU.

The same numpy-seeded inputs, cast to bfloat16 on both sides, go through
the JAX Pallas beam kernels in interpret mode (as
``tests/test_torch_beam.py`` and ``tests/test_pallas_tfm_beam.py`` run
them) and through the port's plain versions, which round where those
kernels round when XLA evaluates them on the CPU:

(a) the whole GRU beam (B1) over the ``CASES`` of
    ``tests/test_torch_beam.py`` at B 37, V 13, H 14, T 10, and the
    transformer beam (B3) at the small transformer width, on a weight tree
    cast to bf16 (``--hw.gen_dtype bfloat16``) and with ``T_args.bf16`` over
    f32 weights: the ys, ptr, adv and fin tapes equal, scores within 2e-2
    (the JAX package's own bf16 tolerance, ``tests/test_pallas_beam.py``).
    One exception, named: the f32 accumulation order of a product (XLA's
    dot against torch's matmul, neither of which can be set) flips a bf16
    rounding in about 1e-4 of the products' elements, one ulp each. Where
    that decides a near-tie the row takes the other branch: at most one
    row per case may differ, and only from a step whose top-K scores agree
    within 2e-2 on both sides. Traced in the ``T_args.bf16`` case: one
    element of the first step's ff2 product, 0.025390625 against
    0.025512695, and every other bf16 value of that step bitwise equal;
(b) one step of each (T 1, the first step of (a)'s runs): the same top-K
    tokens and backpointers, and the step's log-probabilities within 2e-6.
    That holds only if every bf16 value up to the logits is the same on
    both sides: one bf16 ulp of a logit moves them by 1e-3 or more. The f32
    log-softmax (XLA's exp and log against torch's) differs by about one
    f32 ulp;
(c) the fused CLaSS round in bf16 of both families, ``capacity`` None and
    set, against the JAX package's ``latent/fused.py`` with
    ``set_pallas_beam(True)`` under the JAX round's own draws: accept masks
    and tokens equal.

Each JAX kernel configuration compiles once (a few seconds each); the
step tests read the first step of the beam runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.latent import fused as j_fused
from controlled_peptide_generation_tpu.latent import gmm as j_gmm
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import beam as j_beam
from controlled_peptide_generation_tpu.ops import nn as j_nn
from controlled_peptide_generation_tpu.ops import pallas_beam
from controlled_peptide_generation_tpu.ops import pallas_tfm_beam
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.latent import fused as t_fused
from controlled_peptide_generation_tpu_torch.latent import gmm as t_gmm
from controlled_peptide_generation_tpu_torch.models import decoder
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.ops import beam as t_beam
from controlled_peptide_generation_tpu_torch.ops import beam_kernel
from controlled_peptide_generation_tpu_torch.ops import nn as t_nn
from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
from controlled_peptide_generation_tpu_torch.parallel.rounds import shards_of
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

BF = torch.bfloat16
# the cases and inputs of tests/test_torch_beam.py
CASES = [(K, n_best, min_length) for K in (3, 5) for n_best in (1, 3)
         for min_length in (1, 4) if n_best <= K]
SCORE_TOL = 2e-2
STEP_TOL = 2e-6

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one CPU thread for the module: with its default threads
    under a parallel run's workers the cores are oversubscribed (a round of
    this file ran 10-20x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _small(C, family="gru", flag=False):
    cfg = C.default_config()
    cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = 12, 10, 8
    if family == "transformer":
        cfg.model.E_args.E_class = "transformer"
        cfg.model.G_args.G_class = "transformer"
        cfg.model.G_args.T_args.bf16 = flag
    return cfg


@functools.lru_cache(maxsize=None)
def _models(family, flag=False, seed=42):
    """(jax model, jax params, port model, port params) at the small
    width; the weight trees cast to bf16 unless ``flag`` (T_args.bf16 over
    f32 weights)."""
    jm = j_build(_small(JC, family, flag).model, n_vocab=13, max_seq_len=10)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(_small(TC, family, flag).model, n_vocab=13, max_seq_len=10)
    tp = t_ck.params_from_jax(flat)
    if not flag:
        jp, tp = j_nn.cast_tree(jp, jnp.bfloat16), t_nn.cast_tree(tp, BF)
    return jm, jp, tm, tp


def _to_jax(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == BF else jnp.float32)


def _np(tapes):
    return [a.float().numpy() if a.dtype == BF else np.asarray(a)
            for a in tapes]


def _assert_tapes(got, want, tol=SCORE_TOL):
    """The tapes equal, scores within ``tol``, but for at most one row that
    leaves the other side's branch at a near-tie (module docstring)."""
    got, want = _np(got), _np(want)
    same = ((got[0] == want[0]) & (got[1] == want[1])).all(2)     # [B, T]
    rows = np.nonzero(~same.all(1))[0]
    assert len(rows) <= 1, f"rows {rows.tolist()} differ"
    for b in rows:
        t = int(np.argmin(same[b]))
        np.testing.assert_allclose(got[2][b, t], want[2][b, t], rtol=0,
                                   atol=SCORE_TOL, err_msg=f"row {b}")
    keep = np.ones(len(same), bool)
    keep[rows] = False
    for name, i in (("adv", 4), ("fin", 5)):
        np.testing.assert_array_equal(got[i][keep], want[i][keep],
                                      err_msg=name)
    np.testing.assert_allclose(got[2][keep], want[2][keep], rtol=0, atol=tol)
    np.testing.assert_allclose(got[3][keep], want[3][keep], rtol=0, atol=tol)


def _assert_first_step(got, want):
    got, want = _np(got), _np(want)
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][:, 0], want[i][:, 0])
    np.testing.assert_allclose(got[2][:, 0], want[2][:, 0], rtol=0,
                               atol=STEP_TOL)


# ---- (a), (b): the GRU beam ------------------------------------------------

def _scan_inputs(seed, B, V, H):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    return (f(V, 3 * H), f(B, 3 * H), f(H, 3 * H), f(3 * H), f(H, V),
            f(V), f(B, H))


@functools.lru_cache(maxsize=None)
def _gru_pair(K, n_best, min_length, T=10, B=37, V=13, H=14):
    ins = _scan_inputs(K * 100 + n_best * 10 + min_length, B, V, H)
    kw = dict(T=T, K=K, V=V, H=H, min_length=min_length, n_best=n_best)
    want = pallas_beam.beam_scan_gru(
        *(jnp.asarray(a, jnp.bfloat16) for a in ins), **kw, interpret=True)
    got = beam_kernel.beam_scan_gru_reference(
        *(torch.from_numpy(a).to(BF) for a in ins), **kw)
    return got, want


@pytest.mark.parametrize("K,n_best,min_length", CASES)
def test_gru_beam_bf16_matches_pallas_interpret(K, n_best, min_length):
    _assert_tapes(*_gru_pair(K, n_best, min_length))


def test_gru_step_bf16_at_the_kernel_rounding_points():
    got, want = _gru_pair(5, 1, 1)
    _assert_first_step(got, want)
    # a rounding point moved shows at once: the blend in f32, rounded once
    cell = beam_kernel.gru_cell_bf16_points
    ins = _scan_inputs(511, 37, 13, 14)
    kw = dict(T=1, K=5, V=13, H=14, min_length=1, n_best=1)
    try:
        beam_kernel.gru_cell_bf16_points = lambda gi, h, wh, bh: cell(
            gi.float(), h.float(), wh, bh).to(BF)
        moved = beam_kernel.beam_scan_gru_reference(
            *(torch.from_numpy(a).to(BF) for a in ins), **kw)
    finally:
        beam_kernel.gru_cell_bf16_points = cell
    assert np.abs(moved[2][:, 0].numpy() - np.asarray(want[2])[:, 0]).max(
        ) > 1e-4


def test_gru_step_tables_bf16_match_jax():
    """decoder.step_tables in bf16: each product accumulated in f32 and
    rounded once, zc_gi's bias added in bf16, as the JAX package builds its
    kernel's inputs (``ops/beam.py:_beam_search_pallas``)."""
    rng = np.random.default_rng(3)
    E, H = 10, 14
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    emb, wi, bi = f(13, E), f(E + H, 3 * H), f(3 * H)
    z = rng.standard_normal((9, 12)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 9)]

    @jax.jit
    def tables(emb, wi, bi, z, c):
        tok = emb.at[1].set(0.0) @ wi[:E]
        zc_gi = jnp.concatenate([z, c], 1) @ wi[E:] + bi
        return jnp.where(tok == 0.0, 0.0, tok), zc_gi

    want = tables(*(jnp.asarray(a, jnp.bfloat16) for a in (emb, wi, bi, z,
                                                            c)))
    t = lambda a: torch.from_numpy(a).to(BF)
    got = decoder.step_tables({"gru": {"wi": t(wi), "bi": t(bi)}},
                              {"w": t(emb)}, t(z), t(c))
    for g, w in zip(got, want):
        assert g.dtype == BF
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


# ---- (a), (b): the transformer beam -----------------------------------------

@functools.lru_cache(maxsize=None)
def _tfm_pair(flag, seed, K, n_best, min_length, T=10, B=19):
    """The port's plain B3 and the JAX kernel on the same inputs: the
    port's folded decoder (``ops/beam.py:tfm_scan_inputs``), with qkv's
    columns permuted for the JAX kernel as its wrapper does."""
    _, _, tm, tp = _models("transformer", flag)
    rng = np.random.default_rng(seed)
    dt = torch.float32 if flag else BF
    z = torch.from_numpy(rng.standard_normal((B, 12)).astype(np.float32))
    c = torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)])
    ins, dims = t_beam.tfm_scan_inputs(tm, tp, z.to(dt), c.to(dt))
    tok, pos, layers, lnf_g, lnf_b, w_out, b_out, k0s, v0s = ins
    assert tok.dtype == BF and layers[0]["qkv"]["w"].dtype == BF
    assert layers[0]["ln1"]["g"].dtype == (torch.float32 if flag else BF)
    perm = pallas_tfm_beam._perm_qkv_cols(dims["H"], 128)
    j_layers = []
    for lp in layers:
        d = {k: {kk: _to_jax(vv) for kk, vv in v.items()}
             for k, v in lp.items()}
        d["qkv"] = {"w": d["qkv"]["w"][:, perm], "b": d["qkv"]["b"][perm]}
        j_layers.append(d)
    kw = dict(T=T, K=K, V=13, min_length=min_length, n_best=n_best)
    want = pallas_tfm_beam.beam_scan_tfm(
        _to_jax(tok), _to_jax(pos), j_layers, _to_jax(lnf_g),
        _to_jax(lnf_b), _to_jax(w_out), _to_jax(b_out),
        [_to_jax(k) for k in k0s], [_to_jax(v) for v in v0s], S=dims["S"],
        H=dims["H"], F=dims["F"], interpret=True, **kw)
    got = tfm_beam_kernel.beam_scan_tfm_reference(*ins, **kw, **dims)
    return got, want


TFM_CASES = [(False, 0, 5, 3, 1), (True, 1, 4, 1, 4)]


@pytest.mark.parametrize("flag,seed,K,n_best,min_length", TFM_CASES,
                         ids=["cast-K5", "T_args.bf16-K4"])
def test_tfm_beam_bf16_matches_pallas_interpret(flag, seed, K, n_best,
                                                min_length):
    _assert_tapes(*_tfm_pair(flag, seed, K, n_best, min_length))


@pytest.mark.parametrize("case", [0, 1], ids=["cast", "T_args.bf16"])
def test_tfm_step_bf16_at_the_kernel_rounding_points(case):
    _assert_first_step(*_tfm_pair(*TFM_CASES[case]))


def test_tfm_prefix_bf16_matches_jax():
    """init_cache's position-0 rows (the kernel's k0/v0) in bf16 against
    the JAX package's, both weight trees: equal but for the products' f32
    accumulation order (named in the module docstring), which flips at
    most one bf16 rounding in a thousand here."""
    for flag in (False, True):
        jm, jp, tm, tp = _models("transformer", flag)
        rng = np.random.default_rng(5)
        z = rng.standard_normal((19, 12)).astype(np.float32)
        c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 19)]
        dt, jdt = (torch.float32, jnp.float32) if flag else (BF, jnp.bfloat16)
        want = jax.jit(jm.init_decoder_hidden)(jp, jnp.asarray(z, jdt),
                                               jnp.asarray(c, jdt))
        got = tm.init_decoder_hidden(tp, torch.from_numpy(z).to(dt),
                                     torch.from_numpy(c).to(dt))
        for kv in ("k", "v"):
            for w, g in zip(want[kv], got[kv]):
                assert g.dtype == BF
                w = np.asarray(w[:, 0], np.float32)
                g = g[:, 0].float().numpy()
                assert (w == g).mean() >= 0.999, (flag, kv)
                np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2)


# ---- (c): the fused round -------------------------------------------------

def _jax_draws(key, q, n):
    kz, ku, kc = jax.random.split(key, 3)
    kcomp, keps = jax.random.split(kz)
    comp = jax.random.categorical(kcomp, jnp.log(jnp.asarray(q[0])),
                                  shape=(n,))
    eps = jax.random.normal(keps, (n, q[1].shape[1]))
    u = jax.random.uniform(ku, (n,))
    cbit = jax.random.bernoulli(kc, 0.5, (n,))
    T = lambda a: torch.from_numpy(np.array(a))
    return t_fused.RoundDraws(T(comp), T(eps), T(u), T(cbit))


@pytest.mark.parametrize("capacity", [None, 12])
@pytest.mark.parametrize("family", ["gru", "transformer"])
def test_fused_round_bf16_matches_jax(family, capacity):
    """One round at ``decode_dtype="bfloat16"`` (the pipeline's
    ``--hw.gen_dtype bfloat16``) under the JAX round's draws, the JAX beam
    on its Pallas kernel: the same accept mask (fp32 whatever the decode
    type) and the same tokens."""
    def small(C):            # one block of two heads: a shorter JAX compile
        cfg = _small(C, family)
        cfg.model.G_args.T_args.n_layers = 1
        cfg.model.G_args.T_args.n_heads = 2
        return cfg
    jm = j_build(small(JC).model, n_vocab=13, max_seq_len=5)
    jp = jm.init_params(jax.random.PRNGKey(7))
    flat = {k: np.asarray(v) for k, v in j_ck._flatten({"params": jp}).items()}
    tm = t_build(small(TC).model, n_vocab=13, max_seq_len=5)
    tp = t_ck.params_from_jax(flat)
    rng = np.random.default_rng(4)
    w = rng.random(4).astype(np.float32) + 0.2
    q = [w / w.sum(), rng.standard_normal((4, 12)).astype(np.float32),
         (0.5 + rng.random((4, 12))).astype(np.float32)]
    heads = [(0.6 * rng.standard_normal((2, 12))).astype(np.float32),
             np.array([0.3, -0.2], np.float32), np.array([1, 0], np.int32)]
    n, key = 32, jax.random.PRNGKey(17)
    jax.clear_caches()
    j_beam.set_pallas_beam(True)
    try:
        want = j_fused._fused_round(
            jm, jp, key, "gmm_diag", j_gmm.GMMParams(*map(jnp.asarray, q)),
            *map(jnp.asarray, heads), n, beam_size=3,
            decode_dtype="bfloat16", capacity=capacity, beam_chunk=None)
        want = [np.asarray(a) for a in want]
    finally:
        j_beam.set_pallas_beam(None)
        jax.clear_caches()
    got = t_fused._round_body(
        tm, shards_of(tp), _jax_draws(key, q, n), "gmm_diag",
        t_gmm.GMMParams(*map(torch.from_numpy, q)),
        *map(torch.from_numpy, heads), beam_size=3, decode_dtype="bfloat16",
        capacity=capacity)
    got = [a.numpy() for a in got]
    np.testing.assert_array_equal(got[4], want[4])        # accept
    np.testing.assert_array_equal(got[5], want[5])        # tokens
    assert 0 < want[4].sum() < n
    if capacity is not None:
        np.testing.assert_array_equal(got[6], want[6])    # idx
        np.testing.assert_array_equal(got[7], want[7])    # valid
