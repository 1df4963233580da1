"""B2 of the port (ops/gru_kernel.py and ops/gru.gru_scan) against the JAX
package's gru_scan in both of its arms: the XLA scan and the Pallas
gru_seq in interpret mode. On the CPU the port's autograd Function runs
the kernels' plain versions; inside ``cuda_build.plain()`` gru_scan runs
the step loop under torch autograd. Tolerances as tests/test_pallas_gru.py on the CPU: forward
2e-5, gradients rtol 1e-4 / atol 1e-5 (fp32 sums in other orders)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import gru as j_gru
from controlled_peptide_generation_tpu.ops import pallas_gru as j_pg

from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru
from controlled_peptide_generation_tpu_torch.ops import gru_kernel as t_gk

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
NAMES = ("wi", "bi", "wh", "bh")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for the module: its tensors are small, and
    a worker of a parallel test run does not fight the others for
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, I, H):
    rng = np.random.default_rng(seed)
    b = H ** -0.5
    shapes = {"wi": (I, 3 * H), "bi": (3 * H,), "wh": (H, 3 * H),
              "bh": (3 * H,)}
    params = {k: rng.uniform(-b, b, s).astype(np.float32)
              for k, s in shapes.items()}
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return params, f(B, T, I), f(B, H), f(B, T, H), f(B, H)


def _jax_arm(pallas, fn):
    """Run fn with the JAX package's train route forced (as
    tests/test_pallas_gru.py does), restoring auto afterwards."""
    jax.clear_caches()
    j_gru.set_pallas_train(pallas)
    try:
        return fn()
    finally:
        j_gru.set_pallas_train(None)
        jax.clear_caches()


def _jax_scan_and_grads(pallas, params, xs, h0, w_hs, w_hl, reverse):
    def loss(p, x, h):
        hs, hl = j_gru.gru_scan(p, x, h, reverse=reverse)
        return jnp.sum(hs * w_hs) + jnp.sum(hl * w_hl), (hs, hl)

    def run():
        p = {k: jnp.asarray(v) for k, v in params.items()}
        (_, (hs, hl)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                              has_aux=True)(
            p, jnp.asarray(xs), jnp.asarray(h0))
        return jax.tree.map(np.asarray, (hs, hl, g))
    return _jax_arm(pallas, run)


def _torch_scan_and_grads(params, xs, h0, w_hs, w_hl, reverse, plain):
    T = torch.from_numpy
    p = {k: T(v).requires_grad_() for k, v in params.items()}
    x, h = T(xs).requires_grad_(), T(h0).requires_grad_()
    with cuda_build.plain() if plain else contextlib.nullcontext():
        hs, hl = t_gru.gru_scan(p, x, h, reverse=reverse)
    loss = (hs * T(w_hs)).sum() + (hl * T(w_hl)).sum()
    g = torch.autograd.grad(loss, [p[k] for k in NAMES] + [x, h])
    return hs.detach().numpy(), hl.detach().numpy(), [a.numpy() for a in g]


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,I,H", [(8, 5, 9, 16), (3, 1, 4, 6)])
def test_forward_matches_jax(pallas, reverse, B, T, I, H):
    params, xs, h0, w_hs, w_hl = _inputs(B * T + H, B, T, I, H)
    hs_j, hl_j, _ = _jax_scan_and_grads(pallas, params, xs, h0, w_hs, w_hl,
                                        reverse)
    hs, hl, _ = _torch_scan_and_grads(params, xs, h0, w_hs, w_hl, reverse,
                                      plain=False)
    np.testing.assert_allclose(hs, hs_j, **FWD)
    np.testing.assert_allclose(hl, hl_j, **FWD)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("plain", [False, True],
                         ids=["function", "autograd"])
def test_gradients_match_jax(pallas, reverse, plain):
    """Gradients of wi, bi, wh, bh, xs and h0 through the port's route
    (the autograd Function with the plain backward recurrence, or torch
    autograd through the step loop) against jax.grad."""
    params, xs, h0, w_hs, w_hl = _inputs(7, 6, 5, 7, 9)
    *_, (gp, gx, gh) = _jax_scan_and_grads(pallas, params, xs, h0, w_hs,
                                           w_hl, reverse)
    *_, got = _torch_scan_and_grads(params, xs, h0, w_hs, w_hl, reverse,
                                    plain)
    want = [gp[k] for k in NAMES] + [gx, gh]
    for name, a, b in zip(NAMES + ("xs", "h0"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_gru_seq_vjp_matches_pallas_kernel():
    """The port's GruSeq against the Pallas gru_seq (interpret mode) on a
    pre-gated tape: hs, and the vjp's dwh, dbh, dgi, dh0."""
    rng = np.random.default_rng(3)
    T_, B, H = 5, 7, 6
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    wh, bh, gi, h0, dhs = (0.4 * f(H, 3 * H), f(3 * H), f(T_, B, 3 * H),
                           f(B, H), f(T_, B, H))
    hs_j, vjp = jax.vjp(lambda *a: j_pg.gru_seq(*a, None, True),
                        *map(jnp.asarray, (wh, bh, gi, h0)))
    want = vjp(jnp.asarray(dhs))
    args = [torch.from_numpy(a).requires_grad_() for a in (wh, bh, gi, h0)]
    hs = t_gk.gru_seq(*args)
    got = torch.autograd.grad(hs, args, torch.from_numpy(dhs))
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(hs_j), **FWD)
    for name, a, b in zip(("dwh", "dbh", "dgi", "dh0"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD)
    # the plain backward returns the same four directly
    direct = t_gk.gru_seq_bwd_reference(
        *(torch.from_numpy(a) for a in (wh, bh, gi, h0)), hs.detach(),
        torch.from_numpy(dhs))
    for a, b in zip(direct, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_backward_is_the_autograd_gradient_in_float64():
    """The explicit reverse recurrence equals torch autograd through the
    forward step loop to float64 rounding."""
    g = torch.Generator().manual_seed(0)
    T_, B, H = 6, 5, 4
    wh, bh, gi, h0 = (torch.randn(s, generator=g, dtype=torch.float64,
                                  requires_grad=True)
                      for s in ((H, 3 * H), (3 * H,), (T_, B, 3 * H), (B, H)))
    dhs = torch.randn((T_, B, H), generator=g, dtype=torch.float64)
    hs = t_gk.gru_seq_reference(wh, bh, gi, h0)
    want = torch.autograd.grad(hs, (wh, bh, gi, h0), dhs)
    got = t_gk.gru_seq_bwd_reference(wh, bh, gi, h0, hs.detach(), dhs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain versions; a tensor on another
    device than CUDA raises instead of falling back."""
    meta = torch.empty((2, 3, 12), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_gk.gru_seq_fwd(torch.empty((4, 12), device="meta"),
                         torch.empty((12,), device="meta"), meta,
                         torch.empty((3, 4), device="meta"))


def test_ptxas_report_reads_each_instantiation():
    """``ptxas_report`` maps ptxas' -v lines of the scan and weight-gradient
    instantiations to (registers, spill store bytes, spill load bytes),
    ignores other kernels, and reads spills where they occur."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_gru_seq_"
        "cu_115gru_scan_kernelILi13ELi8ELi4EEEvPKfxxS2_S2_S2_PfxxS3_iiii' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN37_INTERNAL_x_15gru_scan",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 3328 bytes smem",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_14gru_bwd_"
        "kernelILi4EEEvPKfS2_' for 'sm_90a'",
        "ptxas info    : Used 90 registers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_16gru_wgrad"
        "_kernelILi2EEEvPKfS2_S2_S2_PfS3_iiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN37_INTERNAL_x_16gru_wgrad",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 64 registers, used 2 barriers"])
    assert t_gk.ptxas_report(log) == {
        "gru_scan_kernel<13, 8, 4>": (72, 0, 0),
        "gru_wgrad_kernel<2>": (64, 4, 8)}


def _jax_pregated_vjp(wh, bh, gi, h0, dhs, pallas):
    """(hs, (dwh, dbh, dgi, dh0)) of the JAX package on a pre-gated tape:
    the Pallas gru_seq in interpret mode, or a jax.lax.scan of its XLA
    cell ``gru_cell_pregated`` (beyond the Pallas kernel's H <= 127)."""
    if pallas:
        fn = lambda *a: j_pg.gru_seq(*a, None, True)  # noqa: E731
    else:
        def fn(wh_, bh_, gi_, h0_):
            def step(h, g):
                h = j_gru.gru_cell_pregated({"wh": wh_, "bh": bh_}, g, h)
                return h, h
            return jax.lax.scan(step, h0_, gi_)[1]
    hs, vjp = jax.vjp(fn, *map(jnp.asarray, (wh, bh, gi, h0)))
    return np.asarray(hs), [np.asarray(a) for a in vjp(jnp.asarray(dhs))]


@pytest.mark.parametrize("B,T_,H", [(8, 5, 16), (3, 1, 6), (5, 5, 1),
                                     (2, 2, 128)])
def test_chain_from_residuals_matches_recompute_and_jax(B, T_, H):
    """The plain version of the CUDA backward (``_bwd_chain_reference``:
    the reverse recurrence given the forward's gates, no recompute), fed
    the residuals of the plain training forward, against the recurrence
    that recomputes the gates (``_bwd_recurrence_reference``; rtol 1e-5)
    and the JAX package's backward: the Pallas ``_bwd_kernel`` in
    interpret mode within its scope (H <= 127), the XLA scan of its cell
    beyond it, on dgi, dh0, dwh and dbh (grads rtol 1e-4)."""
    rng = np.random.default_rng(B * T_ + H)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    wh, bh, gi, h0, dhs = (H ** -0.5 * f(H, 3 * H), f(3 * H),
                           f(T_, B, 3 * H), f(B, H), f(T_, B, H))
    tw, tb, tg, th0, tdhs = map(torch.from_numpy, (wh, bh, gi, h0, dhs))
    hs, res = t_gk.gru_seq_res_reference(tw, tb, tg, th0)
    assert res.shape == (T_, B, H, 4)
    dgi, dghn, dh0 = t_gk._bwd_chain_reference(tw, th0, hs, res, tdhs)
    dwh, dbh = t_gk._wgrad_reference(th0, hs, dgi, dghn)
    got = [a.numpy() for a in (dwh, dbh, dgi, dh0)]
    want = t_gk.gru_seq_bwd_reference(tw, tb, tg, th0, hs, tdhs)
    for name, a, b in zip(("dwh", "dbh", "dgi", "dh0"), got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    hs_j, want_j = _jax_pregated_vjp(wh, bh, gi, h0, dhs, H <= 127)
    np.testing.assert_allclose(hs.numpy(), hs_j, **FWD)
    for name, a, b in zip(("dwh", "dbh", "dgi", "dh0"), got, want_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


def test_gru_seq_bwd_on_cpu_runs_the_chain_reference():
    """``gru_seq_bwd`` takes the forward's residual tape; on CPU tensors
    it returns its kernel's plain version, and ``gru_seq_fwd`` the plain
    training forward's (hs, res)."""
    g = torch.Generator().manual_seed(1)
    T_, B, H = 4, 3, 5
    wh, bh, gi, h0, dhs = (torch.randn(s, generator=g) for s in (
        (H, 3 * H), (3 * H,), (T_, B, 3 * H), (B, H), (T_, B, H)))
    hs, res = t_gk.gru_seq_fwd(wh, bh, gi, h0)
    want = t_gk.gru_seq_res_reference(wh, bh, gi, h0)
    assert torch.equal(hs, want[0]) and torch.equal(res, want[1])
    got = t_gk.gru_seq_bwd(wh, h0, hs, res, dhs)
    for a, b in zip(got, t_gk._bwd_chain_reference(wh, h0, hs, res, dhs)):
        assert torch.equal(a, b)
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        t_gk.gru_seq_bwd(meta(H, 3 * H), meta(B, H), meta(T_, B, H),
                         meta(T_, B, H, 4), meta(T_, B, H))


def test_gru_seq_on_cpu_saves_inputs_and_recomputes():
    """On CPU tensors ``GruSeq`` saves what it saved before the residual
    tape existed (wh, bh, gi, h0, hs) and its gradients are the recompute
    recurrence's, bit for bit."""
    g = torch.Generator().manual_seed(2)
    T_, B, H = 5, 4, 6
    args = [torch.randn(s, generator=g).requires_grad_() for s in (
        (H, 3 * H), (3 * H,), (T_, B, 3 * H), (B, H))]
    dhs = torch.randn((T_, B, H), generator=g)
    hs = t_gk.gru_seq(*args)
    assert len(hs.grad_fn.saved_tensors) == 5
    got = torch.autograd.grad(hs, args, dhs)
    want = t_gk.gru_seq_bwd_reference(*(a.detach() for a in args),
                                      hs.detach(), dhs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ptxas_report_names_the_training_and_backward_instantiations():
    """The training forward's scan (its kRes flag set) and the backward
    kernel are named with their plans in the report."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_15gru_"
        "scan_kernelILi13ELi8ELi1ELb1EEEvPKfxxS2_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 70 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_15gru_"
        "scan_kernelILi13ELi8ELi1ELb0EEEvPKfxxS2_' for 'sm_90a'",
        "ptxas info    : Used 68 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN37_INTERNAL_x_14gru_"
        "bwd_kernelILi32ELi4ELi1EEEvPKfS2_' for 'sm_90a'",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    assert t_gk.ptxas_report(log) == {
        "gru_scan_kernel<13, 8, 1, residuals>": (70, 0, 0),
        "gru_scan_kernel<13, 8, 1>": (68, 0, 0),
        "gru_bwd_kernel<32, 4, 1>": (128, 4, 4)}
