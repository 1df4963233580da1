"""B5 of the port (ops/mmd_kernel.py, the WAE-MMD with the full kernel
matrices) against the JAX package on the CPU: its plain value against the
Pallas kernel ``mmd_full_pallas`` in interpret mode (gaussian, the only
form it has) and against ``losses.mmd_full_kernel`` (all three forms); its
plain backward, the hand-written formula the CUDA kernel computes, against
``jax.grad`` of ``mmd_full_kernel`` in both arguments; the autograd
Function and ``losses.mmd_full_kernel`` (on CPU tensors they run the plain
versions) and the ``cuda_build.plain()`` route.

Tolerances: values atol 1e-5 (fp32 sums of N^2 terms in other orders);
gradients rtol 1e-5 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.ops import pallas_kernels as PK

from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import losses as t_L
from controlled_peptide_generation_tpu_torch.ops import mmd_kernel as t_mk

FORMS = ("gaussian", "laplace", "energy")
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread for the module: its tensors are small, and
    a worker of a parallel test run does not fight the others for
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, n, d):
    """Latent-like z1 (shifted, narrower) and prior-like z2."""
    rng = np.random.default_rng(seed)
    z1 = (0.8 * rng.standard_normal((n, d)) + 0.1).astype(np.float32)
    z2 = rng.standard_normal((n, d)).astype(np.float32)
    return z1, z2


def _max_rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("d", [10, 100])
def test_plain_value_matches_the_pallas_kernel(d):
    z1, z2 = _pair(d, 32, d)
    want = float(PK.mmd_full_pallas(jnp.asarray(z1), jnp.asarray(z2),
                                    sigma=7.0, interpret=True))
    got = t_mk.mmd_full_reference(T(z1), T(z2), 7.0).item()
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("n,d", [(32, 10), (32, 100), (2, 100)])
@pytest.mark.parametrize("form", FORMS)
def test_plain_value_matches_jax(form, n, d):
    z1, z2 = _pair(n + d, n, d)
    want = float(j_L.mmd_full_kernel(jnp.asarray(z1), jnp.asarray(z2), 7.0,
                                     form))
    for got in (t_mk.mmd_full_reference(T(z1), T(z2), 7.0, form),
                t_L.mmd_full_kernel(T(z1), T(z2), 7.0, form)):
        assert abs(got.item() - want) <= 1e-5


@pytest.mark.parametrize("n,d", [(32, 10), (32, 100), (2, 100), (33, 7),
                                 (65, 100), (129, 256)])
@pytest.mark.parametrize("form", FORMS)
def test_plain_backward_matches_jax_grad(form, n, d):
    """dS/dz1 and dS/dz2 by the formula (z2's with the arguments swapped)
    against jax.grad of the JAX loss, and through the autograd Function
    with an upstream gradient of 1.5. The last three shapes are the CUDA
    gradient's tiling edges: N one past a 16- or 64-row tile (a ragged
    last tile of rows a and of rows j), D not a multiple of 4 (4-byte
    copies, padded features) and D 256, the scope's largest."""
    z1, z2 = _pair(3 * n + d, n, d)
    j1, j2 = jax.grad(lambda a, b: j_L.mmd_full_kernel(a, b, 7.0, form),
                      argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
    j1, j2 = np.asarray(j1), np.asarray(j2)
    g1 = t_mk.mmd_full_bwd_reference(T(z1), T(z2), 7.0, form).numpy()
    g2 = t_mk.mmd_full_bwd_reference(T(z2), T(z1), 7.0, form).numpy()
    assert _max_rel(g1, j1) <= 1e-5
    assert _max_rel(g2, j2) <= 1e-5
    a = T(z1).requires_grad_()
    b = T(z2).requires_grad_()
    ga, gb = torch.autograd.grad(1.5 * t_L.mmd_full_kernel(a, b, 7.0, form),
                                 (a, b))
    assert _max_rel(ga.numpy(), 1.5 * j1) <= 1e-5
    assert _max_rel(gb.numpy(), 1.5 * j2) <= 1e-5


@pytest.mark.parametrize("form", FORMS)
def test_one_row_gives_nan_as_jax_does(form):
    """At N 1 the value and both gradients divide 0 by N (N - 1) = 0: NaN in
    the JAX package, in the plain versions and through the route (a batch
    of one row logs a NaN L_wae_mmd and does not stop the run)."""
    z1, z2 = _pair(11, 1, 100)
    want = j_L.mmd_full_kernel(jnp.asarray(z1), jnp.asarray(z2), 7.0, form)
    j1, j2 = jax.grad(lambda a, b: j_L.mmd_full_kernel(a, b, 7.0, form),
                      argnums=(0, 1))(jnp.asarray(z1), jnp.asarray(z2))
    assert np.isnan(float(want))
    assert np.isnan(np.asarray(j1)).all() and np.isnan(np.asarray(j2)).all()
    a = T(z1).requires_grad_()
    b = T(z2).requires_grad_()
    v = t_L.mmd_full_kernel(a, b, 7.0, form)
    ga, gb = torch.autograd.grad(v, (a, b))
    assert torch.isnan(t_mk.mmd_full_reference(T(z1), T(z2), 7.0, form))
    assert torch.isnan(v) and torch.isnan(ga).all() and torch.isnan(gb).all()
    assert torch.isnan(t_mk.mmd_full_bwd_reference(T(z1), T(z2), 7.0,
                                                   form)).all()


def test_plain_context_takes_the_plain_expression():
    """Inside cuda_build.plain() the loss is the plain expression under
    autograd (no Function on the graph); outside it the Function."""
    z1, z2 = _pair(5, 8, 6)
    a = T(z1).requires_grad_()
    with cuda_build.plain():
        v = t_L.mmd_full_kernel(a, T(z2), 7.0)
    assert type(v.grad_fn).__name__ != "MmdFullBackward"
    v2 = t_L.mmd_full_kernel(a, T(z2), 7.0)
    assert type(v2.grad_fn).__name__ == "MmdFullBackward"
    np.testing.assert_allclose(v.item(), v2.item(), rtol=1e-6)


def test_function_launches_no_backward_for_a_logged_value():
    """The default mmdrf run only logs the value: a loss without it never
    reaches the Function's backward."""
    z1, z2 = _pair(6, 8, 6)
    a = T(z1).requires_grad_()
    logged = t_L.mmd_full_kernel(a, T(z2), 7.0)
    calls = []
    real = t_mk.mmd_full_bwd
    try:
        t_mk.mmd_full_bwd = lambda *args: calls.append(1) or real(*args)
        torch.autograd.grad((a ** 2).sum(), a)
    finally:
        t_mk.mmd_full_bwd = real
    assert calls == [] and logged.requires_grad


def test_value_counter_is_per_device_and_stream_and_never_on_cpu(
        monkeypatch):
    """The value kernel's completion counter: one zeroed int32 per (device,
    stream), allocated once and handed back after; CPU calls (the plain
    version, through the Function too) never reach the cache."""
    monkeypatch.setattr(t_mk, "_counters", {})
    made = []
    zeros = torch.zeros

    def fake_zeros(shape, dtype=None, device=None):
        made.append(device)
        return zeros(shape, dtype=dtype)

    def no_counter(*args):
        raise AssertionError("the counter cache was reached on the CPU")

    z1, z2 = _pair(7, 8, 6)
    real_counter = t_mk._counter
    monkeypatch.setattr(t_mk, "_counter", no_counter)
    a = T(z1).requires_grad_()
    v = t_mk.mmd_full_fwd(T(z1), T(z2), 7.0)
    torch.autograd.grad(t_L.mmd_full_kernel(a, T(z2), 7.0), a)
    assert torch.isfinite(v) and t_mk._counters == {}
    monkeypatch.setattr(t_mk, "_counter", real_counter)
    monkeypatch.setattr(t_mk.torch, "zeros", fake_zeros)
    c0 = t_mk._counter(torch.device("cuda", 0), 11)
    assert t_mk._counter(torch.device("cuda", 0), 11) is c0
    c1 = t_mk._counter(torch.device("cuda", 1), 11)
    c2 = t_mk._counter(torch.device("cuda", 0), 12)
    assert c1 is not c0 and c2 is not c0 and c1 is not c2
    assert made == [torch.device("cuda", 0), torch.device("cuda", 1),
                    torch.device("cuda", 0)]
    assert all(c.dtype == torch.int32 and c.tolist() == [0]
               for c in (c0, c1, c2))


def _ptxas_log(spills):
    """A synthetic ptxas -v log of csrc/mmd_full.cu: the value's two
    instantiations and the gradient's two, each with its spill bytes from
    ``spills`` (name -> (stores, loads))."""
    fwd, grad = "EEEvPKfS2_iifiPdPjPf", "EEEvPKfS2_S2_iifiiiPf"
    mangled = {
        "mmd_fwd_kernel<16, 16>": "14mmd_fwd_kernelILi16ELi16" + fwd,
        "mmd_fwd_kernel<32, 8>": "14mmd_fwd_kernelILi32ELi8" + fwd,
        "mmd_grad_kernel<16>": "15mmd_grad_kernelILi16" + grad,
        "mmd_grad_kernel<64>": "15mmd_grad_kernelILi64" + grad}
    lines = []
    for name, m in mangled.items():
        st, ld = spills.get(name, (0, 0))
        lines += [f"ptxas info    : Compiling entry function "
                  f"'_ZN37_INTERNAL_x_{m}' for 'sm_90a'",
                  f"    0 bytes stack frame, {st} bytes spill stores, {ld} "
                  f"bytes spill loads",
                  "ptxas info    : Used 40 registers, used 1 barriers"]
    return "\n".join(lines)


@pytest.mark.parametrize("spilled", [None, "mmd_fwd_kernel<16, 16>",
                                     "mmd_grad_kernel<64>"])
def test_spill_rule_fails_on_any_mmd_kernel(spilled):
    """chip_smoke.py [2]'s rule (``cuda_build.check_no_spills``) on the
    report of csrc/mmd_full.cu: a spill in any instantiation, the value's
    as well as the gradient's, raises; a report without the value's or the
    gradient's kernels raises; a clean one passes."""
    want = ("mmd_fwd_kernel", "mmd_grad_kernel")
    report = t_mk.ptxas_report(_ptxas_log(
        {spilled: (4, 4)} if spilled else {}))
    assert sorted(report) == ["mmd_fwd_kernel<16, 16>",
                              "mmd_fwd_kernel<32, 8>",
                              "mmd_grad_kernel<16>", "mmd_grad_kernel<64>"]
    if spilled is None:
        cuda_build.check_no_spills(report, "mmd_full.cu", want)
        with pytest.raises(AssertionError, match="no ptxas report"):
            cuda_build.check_no_spills(
                {k: v for k, v in report.items()
                 if not k.startswith("mmd_fwd")}, "mmd_full.cu", want)
    else:
        with pytest.raises(AssertionError, match="spills"):
            cuda_build.check_no_spills(report, "mmd_full.cu", want)
