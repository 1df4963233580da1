"""B4 of the port (ops/gru_fwd_kernel.py, the forward-only GRU scan)
against the JAX package on the CPU: its plain version, and ``gru_scan``
without autograd (the route that reaches B4), against the Pallas kernel
``gru_scan_pallas`` in interpret mode and the XLA ``gru_scan``, forward and
reverse, at the shapes of tests/test_pallas.py. hs and h_T within 1e-5
(fp32 sums in other orders). Also: which scans take the B4 route, and
``cuda_build.plain()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import gru as j_gru
from controlled_peptide_generation_tpu.ops import pallas_kernels as PK

from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru
from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel as t_gf
from controlled_peptide_generation_tpu_torch.ops import gru_kernel as t_gk

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(8, 12, 10, 16), (4, 7, 6, 8)]          # B, T, in, H


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
    xs = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    return params, xs, h0


def _jax(params, xs, h0, reverse):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    x, h = jnp.asarray(xs), jnp.asarray(h0)
    pallas = PK.gru_scan_pallas(p, x, h, reverse=reverse, interpret=True)
    xla = j_gru.gru_scan(p, x, h, reverse=reverse)
    return [tuple(np.asarray(a) for a in arm) for arm in (pallas, xla)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,T,I,H", SHAPES)
def test_plain_version_and_scan_match_jax(reverse, B, T, I, H):
    params, xs, h0 = _inputs(B * T + H + reverse, B, T, I, H)
    arms = _jax(params, xs, h0, reverse)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x, h = torch.from_numpy(xs), torch.from_numpy(h0)
    gi_tm = (x @ tp["wi"] + tp["bi"]).transpose(0, 1)      # a strided view
    hs_tm, hT = t_gf.gru_fwd_reference(tp["wh"], tp["bh"], gi_tm, h,
                                       reverse)
    via_wrapper = t_gf.gru_fwd(tp["wh"], tp["bh"], gi_tm, h, reverse)
    with torch.no_grad():
        scan = t_gru.gru_scan(tp, x, h, reverse=reverse)
    for got_hs, got_hT in ((hs_tm.transpose(0, 1), hT),
                           (via_wrapper[0].transpose(0, 1), via_wrapper[1]),
                           scan):
        for want_hs, want_hT in arms:
            np.testing.assert_allclose(got_hs.numpy(), want_hs, **TOL)
            np.testing.assert_allclose(got_hT.numpy(), want_hT, **TOL)


def test_route_follows_autograd(monkeypatch):
    """A scan that autograd records runs B2 (gru_kernel.gru_seq); under
    no_grad, or with no input requiring grad, it runs B4, and inside
    cuda_build.plain() B4's plain version."""
    params, xs, h0 = _inputs(1, 3, 5, 4, 6)
    calls = []
    real_fwd, real_seq = t_gf.gru_fwd, t_gk.gru_seq
    monkeypatch.setattr(t_gf, "gru_fwd", lambda *a: calls.append("B4")
                        or real_fwd(*a))
    monkeypatch.setattr(t_gk, "gru_seq", lambda *a: calls.append("B2")
                        or real_seq(*a))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x, h = torch.from_numpy(xs), torch.from_numpy(h0)
    t_gru.gru_scan(tp, x, h)
    with torch.no_grad():
        t_gru.gru_scan({k: v.requires_grad_() for k, v in tp.items()}, x, h,
                       reverse=True)
    out = t_gru.gru_scan(tp, x, h)
    assert out[0].requires_grad
    with cuda_build.plain(), torch.no_grad():
        t_gru.gru_scan(tp, x, h)
    assert calls == ["B4", "B4", "B2"]
