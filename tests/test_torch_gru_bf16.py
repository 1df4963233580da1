"""B2 in bf16: the port's plain bf16 versions (ops/gru_kernel.py) against
the JAX package's ``pallas_gru.gru_seq`` in bf16, interpret mode, as
``tests/test_pallas_gru.py`` runs it on the CPU.

The plain versions round where XLA evaluates the JAX kernels' bf16
(``gru_kernel._gates_bf16``: a bf16 sum cast straight to f32 keeps no
rounding there). Inputs from a numpy seed at the model's scales (wh and
bh uniform in +-H^-1/2, gi and the cotangents standard normal), cast to
bf16 on both sides.

Tolerances. hs: bitwise on at least 99.9% of elements and within one bf16
ulp everywhere (at these cases it is bitwise everywhere: both sides sum
the products in f32 and round at the same points). Gradients (dgi, dh0, dwh, dbh, under ``jax.grad`` and
``torch.autograd``): bitwise on at least 99% of elements of each, and
every element within two bf16 ulps of the tensor's largest magnitude
(2^-7 max|want|). Why: each product is summed in f32 in another order
(torch's matmul against XLA's dot; neither can be set). Where that flips
the rounding of a gate gradient by one ulp (about 1e-4 of them at T 25,
H 80), the flip enters the carried dh through wh and reaches the earlier
steps' gradients and the f32 sums of dwh and dbh; at H 80, T 25 the
largest such difference is 0.24% of the tensor's largest magnitude
(dwh), within one ulp of it.

Also here: the backward from the forward's residual tape (the CUDA
kernels' plain version) gives the same bits as the recompute; a bf16
``gru_scan`` takes B2 without autograd too, never B4; the scope and dtype
checks; and the JAX B4 and B5 raise on bf16 inputs, which is why the
port's B4 and B5 take float32 only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import gru as j_gru
from controlled_peptide_generation_tpu.ops import pallas_gru as j_pg
from controlled_peptide_generation_tpu.ops import pallas_kernels as j_pk

from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru
from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel
from controlled_peptide_generation_tpu_torch.ops import gru_kernel as t_gk

BF = torch.bfloat16
# the last: an odd H at the scope's edge (127), where the CUDA weight
# gradient reads rows by plain loads
CASES = [(5, 4, 16), (12, 6, 40), (25, 8, 80), (6, 3, 127)]
GRAD_BITWISE = 0.99
GRAD_ULPS = 2
BIAS_SUM_TOL = 2.0 ** -5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """torch on one CPU thread for the module (parallel test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, T, B, H):
    rng = np.random.default_rng(seed)
    b = H ** -0.5
    return (rng.uniform(-b, b, (H, 3 * H)).astype(np.float32),
            rng.uniform(-b, b, (3 * H,)).astype(np.float32),
            rng.standard_normal((T, B, 3 * H)).astype(np.float32),
            (0.5 * rng.standard_normal((B, H))).astype(np.float32),
            rng.standard_normal((T, B, H)).astype(np.float32))


def _bf(a):
    return torch.from_numpy(a).to(BF)


def _np(x):
    return np.asarray(x.astype(jnp.float32) if hasattr(x, "astype")
                      and not isinstance(x, np.ndarray) else x)


def _jax_run(wh, bh, gi, h0, w):
    """hs and grad of sum(hs * w) in (wh, bh, gi, h0), all bf16 in."""
    args = [jnp.asarray(a, jnp.bfloat16) for a in (wh, bh, gi, h0)]
    hs = j_pg.gru_seq(*args, None, True)

    def loss(*a):
        return jnp.sum(j_pg.gru_seq(*a, None, True).astype(jnp.float32)
                       * jnp.asarray(w))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(x.astype(jnp.float32)) for x in (hs, *grads)]


def _torch_run(wh, bh, gi, h0, w):
    args = [_bf(a).requires_grad_() for a in (wh, bh, gi, h0)]
    hs = t_gk.gru_seq(*args)
    assert hs.dtype == BF
    grads = torch.autograd.grad((hs.float() * torch.from_numpy(w)).sum(),
                                args)
    assert all(g.dtype == BF for g in grads)
    return [x.detach().float().numpy() for x in (hs, *grads)]


def _ulp(x):
    """One bf16 ulp of |x| (x bf16 values held as f32)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("T,B,H", CASES)
def test_bf16_b2_matches_pallas_interpret(T, B, H):
    wh, bh, gi, h0, w = _inputs(T * 100 + B * 10 + H, T, B, H)
    want = _jax_run(wh, bh, gi, h0, w)
    got = _torch_run(wh, bh, gi, h0, w)
    hs_w, hs_g = want[0], got[0]
    assert (hs_g == hs_w).mean() >= 0.999
    assert (np.abs(hs_g - hs_w) <= _ulp(hs_w)).all()
    # gradients: want is (dwh, dbh, dgi, dh0) in the argument order
    for name, g, x in zip(("dwh", "dbh", "dgi", "dh0"), got[1:], want[1:]):
        assert g.shape == x.shape, name
        assert (g == x).mean() >= GRAD_BITWISE, name
        bound = GRAD_ULPS * 2.0 ** -8 * np.abs(x).max()
        assert np.abs(g - x).max() <= bound, (name, np.abs(g - x).max())


@pytest.mark.parametrize("reverse", [False, True])
def test_bf16_gru_scan_matches_jax_pallas_route(reverse):
    """The whole gru_scan in bf16 with autograd (input projection, flip,
    B2) against the JAX gru_scan on its Pallas route, as the JAX package
    sends a bf16 scan there: hs and h_last, and the gradient in every
    parameter, x and h0, within the gradients' tolerance above (here they
    are bitwise equal), but for dbi. That one is the sum over B and T of
    the bf16 dgi, outside B2: XLA reduces the broadcast's bf16 cotangent in
    bf16, each partial sum rounded, torch sums a bf16 tensor in f32 and
    rounds once; about 70% of its elements differ, within 1.4% of its
    largest magnitude (``BIAS_SUM_TOL``: 2^-5, four bf16 ulps of it)."""
    T, B, I, H = 10, 6, 9, 24
    rng = np.random.default_rng(11 + reverse)
    b = H ** -0.5
    params = {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in
              (("wi", (I, 3 * H)), ("wh", (H, 3 * H)), ("bi", (3 * H,)),
               ("bh", (3 * H,)))}
    xs = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    w = rng.standard_normal((B, T, H)).astype(np.float32)

    def jloss(p, x, h):
        hs, hl = j_gru.gru_scan(p, x, h, reverse=reverse)
        return jnp.sum(hs.astype(jnp.float32) * w) + jnp.sum(
            hl.astype(jnp.float32)), (hs, hl)
    jax.clear_caches()
    j_gru.set_pallas_train(True)
    try:
        (_, (hs_j, hl_j)), g_j = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()},
            jnp.asarray(xs, jnp.bfloat16), jnp.asarray(h0, jnp.bfloat16))
    finally:
        j_gru.set_pallas_train(None)
        jax.clear_caches()
    p = {k: _bf(v).requires_grad_() for k, v in params.items()}
    x, h = _bf(xs).requires_grad_(), _bf(h0).requires_grad_()
    hs, hl = t_gru.gru_scan(p, x, h, reverse=reverse)
    loss = (hs.float() * torch.from_numpy(w)).sum() + hl.float().sum()
    names = ("wi", "wh", "bi", "bh")
    g_t = torch.autograd.grad(loss, [p[k] for k in names] + [x, h])
    want = [_np(hs_j), _np(hl_j)] + [_np(g_j[0][k]) for k in names] + [
        _np(g_j[1]), _np(g_j[2])]
    got = [a.detach().float().numpy() for a in (hs, hl, *g_t)]
    for i, (g, x_) in enumerate(zip(got, want)):
        if i == 4:      # dbi: the bias broadcast's reduction, not B2's
            assert np.abs(g - x_).max() <= BIAS_SUM_TOL * np.abs(x_).max()
            continue
        assert (g == x_).mean() >= GRAD_BITWISE, i
        bound = GRAD_ULPS * 2.0 ** -8 * np.abs(x_).max()
        assert np.abs(g - x_).max() <= bound, (i, np.abs(g - x_).max())


@pytest.mark.parametrize("T,B,H", CASES)
def test_residual_chain_gives_the_recompute_bits(T, B, H):
    """The CUDA backward reads the forward's residual tape; in bf16 the
    tape holds the unrounded f32 gates and the rounded gh_n, what the JAX
    backward recomputes, so the chain's plain version gives the
    recompute's bits."""
    wh, bh, gi, h0, dhs = (_bf(a) for a in _inputs(7 + H, T, B, H))
    hs, res = t_gk.gru_seq_fwd(wh, bh, gi, h0)
    assert hs.dtype == BF and res.dtype == torch.float32
    chain = t_gk.gru_seq_bwd(wh, h0, hs, res, dhs)
    recompute = t_gk._bwd_recurrence_reference(wh, bh, gi, h0, hs, dhs)
    for a, b in zip(chain, recompute):
        assert a.dtype == BF and torch.equal(a, b)
    dwh, dbh = t_gk.gru_seq_wgrad(h0, hs, chain[0], chain[1])
    want = t_gk.gru_seq_bwd_reference(wh, bh, gi, h0, hs, dhs)
    assert torch.equal(dwh, want[0]) and torch.equal(dbh, want[1])
    # a tape of the bf16-rounded gates gives other gradients
    rounded = torch.cat([res[..., :3].to(BF).float(), res[..., 3:]], -1)
    moved = t_gk.gru_seq_bwd(wh, h0, hs, rounded, dhs)
    assert not torch.equal(moved[0], chain[0])


def test_bf16_scan_without_autograd_takes_b2(monkeypatch):
    """Without autograd a float32 scan runs B4; a bf16 one runs B2's
    forward with no residual tape (hs alone, as the JAX forward writes),
    as the JAX package sends a bf16 scan to its pallas_gru.gru_seq."""
    def refuse(*a, **k):
        raise AssertionError("B4 ran on a bf16 scan")
    monkeypatch.setattr(gru_fwd_kernel, "gru_fwd", refuse)
    monkeypatch.setattr(gru_fwd_kernel, "gru_fwd_reference", refuse)
    real_fwd, tapes = t_gk.gru_seq_fwd, []

    def fwd(*a, residuals=True):
        out = real_fwd(*a, residuals=residuals)
        tapes.append(out[1])
        return out
    monkeypatch.setattr(t_gk, "gru_seq_fwd", fwd)
    rng = np.random.default_rng(5)
    H, I = 12, 7
    p = {k: _bf(rng.uniform(-0.3, 0.3, s).astype(np.float32)) for k, s in
         (("wi", (I, 3 * H)), ("wh", (H, 3 * H)), ("bi", (3 * H,)),
          ("bh", (3 * H,)))}
    xs = _bf(rng.standard_normal((3, 6, I)).astype(np.float32))
    h0 = _bf(rng.standard_normal((3, H)).astype(np.float32))
    gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1)
    for reverse in (False, True):
        with torch.no_grad():
            hs, hl = t_gru.gru_scan(p, xs, h0, reverse=reverse)
            with cuda_build.plain():
                hs_p, _ = t_gru.gru_scan(p, xs, h0, reverse=reverse)
        tape = gi.flip(0) if reverse else gi
        want = t_gk.gru_seq_reference(p["wh"], p["bh"], tape.contiguous(),
                                      h0)
        assert torch.equal(hl, want[-1])
        want = want.flip(0) if reverse else want
        assert torch.equal(hs, want.transpose(0, 1))
        assert torch.equal(hs_p, hs)
    # one forward a direction, each without a tape (the plain side calls
    # none), and the tape-free forward gives the training forward's hs
    assert tapes == [None, None]
    hs_free, none = real_fwd(p["wh"], p["bh"], gi.contiguous(), h0,
                             residuals=False)
    assert none is None
    assert torch.equal(hs_free, real_fwd(p["wh"], p["bh"], gi.contiguous(),
                                         h0)[0])


def test_bf16_scope_and_dtypes():
    """The B2 entries take float32 and bf16 (bf16 up to H 127, the JAX
    kernel's scope); B4 takes float32 only and says why; a tensor of
    another dtype than the first is named."""
    f = lambda *s, dt=BF: torch.zeros(s, dtype=dt)  # noqa: E731
    named = lambda H, dt=BF: {"wh": (f(H, 3 * H, dt=dt), (H, 3 * H)),  # noqa
                              "h0": (f(2, H, dt=dt), (2, H))}
    assert t_gk._validate(named(127), 3, 2, 127) == torch.device("cpu")
    t_gk._validate(named(128, torch.float32), 3, 2, 128)
    with pytest.raises(ValueError, match="127"):
        t_gk._validate(named(128), 3, 2, 128)
    with pytest.raises(NotImplementedError, match="float16"):
        t_gk._validate(named(8, torch.float16), 3, 2, 8)
    mixed = named(8)
    mixed["h0"] = (f(2, 8, dt=torch.float32), (2, 8))
    with pytest.raises(ValueError, match="h0 is torch.float32"):
        t_gk._validate(mixed, 3, 2, 8)
    res = {"wh": (f(8, 24), (8, 24)),
           "res": (f(3, 2, 8, 4, dt=torch.float32), (3, 2, 8, 4))}
    t_gk._validate(res, 3, 2, 8, f32=("res",))
    bf = {n: torch.zeros(s, dtype=BF, device="meta") for n, s in
          (("gi", (3, 2, 24)), ("wh", (8, 24)), ("bh", (24,)), ("h0", (2, 8)))}
    with pytest.raises(NotImplementedError, match="B4.*float32 only"):
        gru_fwd_kernel.gru_fwd(bf["wh"], bf["bh"], bf["gi"], bf["h0"])


def test_jax_b4_and_b5_raise_on_bf16():
    """The JAX package's B4 (pallas_kernels.gru_sequence_pallas) and B5
    (mmd_full_pallas) raise on bf16 inputs in interpret mode: each stores
    an f32 value into a bf16 ref. So they have no bf16 contract to port,
    and the port's B4 and B5 take float32 only."""
    rng = np.random.default_rng(0)
    T, B, H = 5, 4, 16
    bf = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.bfloat16)  # noqa
    with pytest.raises(ValueError, match="Invalid dtype"):
        j_pk.gru_sequence_pallas(bf(T, B, 3 * H), bf(H, 3 * H), bf(3 * H),
                                 bf(B, H), interpret=True)
    with pytest.raises(ValueError, match="Invalid dtype"):
        j_pk.mmd_full_pallas(bf(8, 6), bf(8, 6), interpret=True)
    # the same calls in float32 run
    f = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)  # noqa
    hs, _ = j_pk.gru_sequence_pallas(f(T, B, 3 * H), f(H, 3 * H), f(3 * H),
                                     f(B, H), interpret=True)
    assert hs.dtype == jnp.float32
    assert np.isfinite(float(j_pk.mmd_full_pallas(f(8, 6), f(8, 6),
                                                  interpret=True)))


def test_ptxas_report_names_the_bf16_instantiations():
    """The bf16 instantiations (the storage type last among the template
    arguments) are reported apart from the float32 ones, and the bf16
    weight gradient on the tensor cores (bf16 alone: its argument is the
    staging, bulk copies or plain loads) by its own name."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_15gru_"
        "scan_kernelILi13ELi8ELi1ELb1E13__nv_bfloat16EEvPKT3_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_15gru_"
        "scan_kernelILi13ELi8ELi1ELb1EfEEvPKT3_' for 'sm_90a'",
        "ptxas info    : Used 70 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_14gru_"
        "bwd_kernelILi32ELi4ELi1E13__nv_bfloat16EEvPKT2_' for 'sm_90a'",
        "ptxas info    : Used 126 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_16gru_"
        "wgrad_kernelILi2E13__nv_bfloat16EEvPKT0_' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_20gru_"
        "wgrad_mma_kernelILb1ELi160EEEvPK13__nv_bfloat16S3_S3_S3_PS1_S4_"
        "iiiiPfPj' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert t_gk.ptxas_report(log) == {
        "gru_scan_kernel<13, 8, 1, residuals, bf16>": (72, 0, 0),
        "gru_scan_kernel<13, 8, 1, residuals>": (70, 0, 0),
        "gru_bwd_kernel<32, 4, 1, bf16>": (126, 0, 0),
        "gru_wgrad_kernel<2, bf16>": (64, 4, 8),
        "gru_wgrad_mma_kernel<bulk, 160, bf16>": (168, 0, 0)}
