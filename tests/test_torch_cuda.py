"""Tests of the port's CUDA kernels that need the card (marker ``cuda``;
they skip without one). This file imports torch and the port only, so it
runs on a machine without jax:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import contextlib

import pytest
import torch

from controlled_peptide_generation_tpu_torch.ops import cuda_build
from controlled_peptide_generation_tpu_torch.ops import gru as t_gru
from controlled_peptide_generation_tpu_torch.ops import gru_kernel as t_gk

NAMES = ("wi", "bi", "wh", "bh")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """On the card: the kernels against their plain versions at the
    shipped widths and the scope edges (hs within 1e-4, each gradient
    within 1e-3 of its largest entry), and a bitwise repeatable
    backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    for I, H, B, T_ in ((150, 80, 37, 25), (252, 102, 32, 25),
                        (16, t_gk.MAX_H, 5, 1)):
        p = {k: v.requires_grad_() for k, v in
             t_gru.init_gru_params(g, I, H, dev).items()}
        xs = torch.randn((B, T_, I), generator=g, device=dev,
                         requires_grad=True)
        h0 = torch.randn((B, H), generator=g, device=dev, requires_grad=True)
        w = torch.randn((B, T_, H), generator=g, device=dev)
        runs = []
        for plain in (False, True, False):
            with cuda_build.plain() if plain else contextlib.nullcontext():
                hs, _ = t_gru.gru_scan(p, xs, h0, reverse=True)
                grads = torch.autograd.grad((hs * w).sum(),
                                            [p[k] for k in NAMES]
                                            + [xs, h0])
            runs.append((hs.detach(), grads))
        assert (runs[0][0] - runs[1][0]).abs().max().item() <= 1e-4
        for a, b in zip(runs[0][1], runs[1][1]):
            assert (a - b).abs().max() <= 1e-3 * b.abs().max()
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[2][1]))


@pytest.mark.cuda
def test_weight_gradient_kernel_matches_reference_and_mm_on_the_card():
    """On the card: the weight-gradient kernel (one cluster launch per
    call) against its plain version and against one torch.mm of
    [h_{t-1} | 1]^T by dgh at the decoder width, B 32 and 1,024 (within
    1e-3 of each tensor's largest entry), two runs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(3)
    T_, H = 25, 102
    for B in (32, 1024):
        p = t_gru.init_gru_params(g, 252, H, dev)
        xs = torch.randn((B, T_, 252), generator=g, device=dev)
        h0 = 0.5 * torch.randn((B, H), generator=g, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs = t_gk.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=g, device=dev)
        dgi, dghn, _ = t_gk.gru_seq_bwd(p["wh"], p["bh"], gi, h0, hs, dhs)
        before = t_gk.gru_seq_wgrad.launches
        runs = [t_gk.gru_seq_wgrad(h0, hs, dgi, dghn) for _ in range(2)]
        ref = t_gk._wgrad_reference(h0, hs, dgi, dghn)
        hprev1 = torch.cat([torch.cat([h0[None], hs[:-1]]).reshape(-1, H),
                            torch.ones((T_ * B, 1), device=dev)], 1)
        dgh = torch.cat([dgi[..., :2 * H], dghn], 2).reshape(-1, 3 * H)
        mm = torch.mm(hprev1.T, dgh)
        torch.cuda.synchronize()
        assert t_gk.gru_seq_wgrad.launches == before + 2
        for got, want in zip(runs[0], ref):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
        for got, want in zip(runs[0], (mm[:H], mm[H])):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_scan_is_batch_invariant_at_the_scope_edges_on_the_card():
    """On the card: the scan kernel at H 128 (the scope's largest, four
    lanes per unit) and H 1 (one unit, its slices zero-padded), both
    directions: hs and h_T within 1e-4 of the plain version, and the
    first rows of B 1,037 equal to B 1, 5 and 37 bitwise (other rows per
    block, the same sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)
    for H in (t_gk.MAX_H, 1):
        p = t_gru.init_gru_params(g, 16, H, dev)
        xs = torch.randn((1037, 25, 16), generator=g, device=dev)
        h0 = 0.5 * torch.randn((1037, H), generator=g, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1)
        for reverse in (False, True):
            full = gru_fwd_kernel.gru_fwd(p["wh"], p["bh"], gi, h0, reverse)
            ref = gru_fwd_kernel.gru_fwd_reference(p["wh"], p["bh"], gi, h0,
                                                   reverse)
            torch.cuda.synchronize()
            assert (full[0] - ref[0]).abs().max().item() <= 1e-4
            assert (full[1] - ref[1]).abs().max().item() <= 1e-4
            for B in (1, 5, 37):
                head = gru_fwd_kernel.gru_fwd(p["wh"], p["bh"], gi[:, :B],
                                              h0[:B], reverse)
                assert torch.equal(head[0], full[0][:, :B])
                assert torch.equal(head[1], full[1][:B])


@pytest.mark.cuda
def test_transformer_beam_kernel_matches_plain_version_on_the_card():
    """On the card: B3 against its plain version at the shipped
    transformer width, >= 99% of rows with identical token and pointer
    tapes, final scores on those rows within 1e-3, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
        build_model)
    from controlled_peptide_generation_tpu_torch.ops import beam
    from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, _ = C.parse_and_finalize(["--model.E_args.E_class", "transformer",
                                      "--model.G_args.G_class",
                                      "transformer"])
    model = build_model(cfg.model, 24, 25)
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(g, dev)
    z = torch.randn((300, model.z_dim), generator=g, device=dev)
    c = model.sample_c_prior(g, 300, device=dev)
    ins, dims = beam.tfm_scan_inputs(model, params, z, c)
    kw = dict(T=25, K=5, V=24, min_length=1, n_best=1, **dims)
    before = tfm_beam_kernel.beam_scan_tfm.launches
    got = tfm_beam_kernel.beam_scan_tfm(*ins, **kw)
    ref = tfm_beam_kernel.beam_scan_tfm_reference(*ins, **kw)
    torch.cuda.synchronize()
    assert tfm_beam_kernel.beam_scan_tfm.launches == before + 1
    same = ((got[0] == ref[0]).all(dim=(1, 2))
            & (got[1] == ref[1]).all(dim=(1, 2)))
    assert same.float().mean().item() >= 0.99
    assert (got[3] - ref[3]).abs()[same].max().item() <= 1e-3


@pytest.mark.cuda
def test_forward_only_scan_matches_plain_version_on_the_card():
    """On the card: B4 (gru_scan without autograd) against its plain
    version at the encoder width, both directions, a batch that is no
    multiple of the rows per block (hs and h_T within 1e-4), one launch
    counted per scan, batch invariance on one tape (bitwise: the rows of
    a smaller batch's own projection are another cuBLAS product) and B2's
    forward, the same scan kernel, equal to B4 (bitwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch.ops import gru_fwd_kernel
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    p = t_gru.init_gru_params(g, 150, 80, dev)
    xs = torch.randn((1037, 25, 150), generator=g, device=dev)
    h0 = torch.randn((1037, 80), generator=g, device=dev)
    gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1)      # as gru_scan makes it
    wh, bh = p["wh"], p["bh"]
    for reverse in (False, True):
        before = gru_fwd_kernel.gru_fwd.launches
        with torch.no_grad():
            hs, hT = t_gru.gru_scan(p, xs, h0, reverse=reverse)
            with cuda_build.plain():
                hs_ref, hT_ref = t_gru.gru_scan(p, xs, h0, reverse=reverse)
        torch.cuda.synchronize()
        assert gru_fwd_kernel.gru_fwd.launches == before + 1
        assert (hs - hs_ref).abs().max().item() <= 1e-4
        assert (hT - hT_ref).abs().max().item() <= 1e-4
        full = gru_fwd_kernel.gru_fwd(wh, bh, gi, h0, reverse)
        head = gru_fwd_kernel.gru_fwd(wh, bh, gi[:, :37], h0[:37], reverse)
        assert torch.equal(head[0], full[0][:, :37])
        assert torch.equal(head[1], full[1][:37])
        if not reverse:
            hs2 = t_gk.gru_seq_fwd(wh, bh, gi.contiguous(), h0)
            assert torch.equal(hs2, full[0])


@pytest.mark.cuda
def test_mmd_kernels_match_plain_versions_on_the_card():
    """On the card: B5's value (|delta| <= 1e-5) and both gradients
    (within 1e-4 of their largest entry) against the plain versions, for
    the three kernel forms at the train step's N 32, D 100; bitwise
    repeatable; NaN at N 1, as the plain versions give."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch.ops import losses as t_L
    from controlled_peptide_generation_tpu_torch.ops import mmd_kernel
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    z1 = 0.8 * torch.randn((32, 100), generator=g, device=dev) + 0.1
    z2 = torch.randn((32, 100), generator=g, device=dev)
    for form in ("gaussian", "laplace", "energy"):
        runs = []
        for plain in (False, False, True):
            a = z1.clone().requires_grad_()
            b = z2.clone().requires_grad_()
            with cuda_build.plain() if plain else contextlib.nullcontext():
                v = t_L.mmd_full_kernel(a, b, 7.0, form)
                runs.append((v.detach(),) + torch.autograd.grad(v, (a, b)))
        torch.cuda.synchronize()
        assert abs(runs[0][0].item() - runs[2][0].item()) <= 1e-5
        for got, want in zip(runs[0][1:], runs[2][1:]):
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
        assert all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
        # one row: NaN value and gradients, as the plain versions give
        a = z1[:1].clone().requires_grad_()
        v = t_L.mmd_full_kernel(a, z2[:1], 7.0, form)
        (ga,) = torch.autograd.grad(v, (a,))
        assert torch.isnan(v) and torch.isnan(ga).all()
    assert mmd_kernel.mmd_full_fwd.launches >= 9
    assert mmd_kernel.mmd_full_bwd.launches >= 15


def _beam_cases(dev):
    """(tag, scan, stamped, plain, inputs of batch B, dims) of B1 and B3 at
    the shipped widths, seeded random weights, f32 and bf16 (the weight
    tree cast as --hw.gen_dtype bfloat16 casts it)."""
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
        build_model)
    from controlled_peptide_generation_tpu_torch.ops import beam
    from controlled_peptide_generation_tpu_torch.ops import beam_kernel
    from controlled_peptide_generation_tpu_torch.ops import nn
    from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
    tfm = ["--model.E_args.E_class", "transformer", "--model.G_args.G_class",
           "transformer"]
    for fam, flags in (("B1", []), ("B3", tfm)):
        cfg, _, _ = C.parse_and_finalize(flags)
        model = build_model(cfg.model, 24, 25)
        g = torch.Generator(device=dev).manual_seed(0)
        params = model.init_params(g, dev)
        for dt in (torch.float32, torch.bfloat16):
            p = params if dt == torch.float32 else nn.cast_tree(params, dt)

            def inputs(B, model=model, p=p):
                gz = torch.Generator(device=dev).manual_seed(1)
                z = torch.randn((B, model.z_dim), generator=gz, device=dev)
                c = model.sample_c_prior(gz, B, device=dev)
                return beam.decode_inputs(model, p, z, c)

            kern = (tfm_beam_kernel if fam == "B3" else beam_kernel)
            scan = (kern.beam_scan_tfm if fam == "B3"
                    else kern.beam_scan_gru)
            stamped = (kern.beam_scan_tfm_stamped if fam == "B3"
                       else kern.beam_scan_gru_stamped)
            plain = (kern.beam_scan_tfm_reference if fam == "B3"
                     else kern.beam_scan_gru_reference)
            yield f"{fam} {dt}", scan, stamped, plain, inputs, dt


@pytest.mark.cuda
def test_beam_kernels_at_partial_waves_and_uneven_batches_on_the_card():
    """On the card: B1 and B3, f32 and bf16, against their plain versions
    at batches that leave the last wave or round of the grid partial
    (1,500 and 2,500) and that are no multiple of the sentences per block
    (37, 1,001): f32 >= 99% identical token rows with final scores within
    1e-3 on them, bf16 >= 70% identical rows at T 25 (chip_smoke.py's
    gates); and every batch's rows equal the first rows of the largest
    bitwise (batch invariance across plans)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, scan, _, plain, inputs, dt in _beam_cases(dev):
        outs = {}
        for B in (2500, 1500, 1001, 37):
            ins, dims = inputs(B)
            kw = dict(T=25, K=5, V=24, min_length=1, n_best=1, **dims)
            got = scan(*ins, **kw)
            ref = plain(*ins, **kw)
            torch.cuda.synchronize()
            same = ((got[0] == ref[0]).all(dim=(1, 2))
                    & (got[1] == ref[1]).all(dim=(1, 2)))
            if dt == torch.float32:
                assert same.float().mean().item() >= 0.99, (tag, B)
                assert (got[3] - ref[3]).abs()[same].max().item() <= 1e-3
            else:
                assert same.float().mean().item() >= 0.70, (tag, B)
            outs[B] = got
        for B in (1500, 1001, 37):
            assert all(torch.equal(a[:B], b) for a, b in
                       zip(outs[2500], outs[B])), (tag, B)


@pytest.mark.cuda
def test_stamp_entries_give_the_production_tapes_on_the_card():
    """On the card: the stamp entries (the kernels compiled with their
    phase clocks, for measurement only) give the production entries' tapes
    bitwise, count no launch, and report a share for every phase that sums
    to at most 1 for each recorded block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    for tag, scan, stamped, _, inputs, _ in _beam_cases(dev):
        ins, dims = inputs(1001)
        kw = dict(T=25, K=5, V=24, min_length=1, n_best=1, **dims)
        counts = (scan.launches, scan.launches_bf16)
        got, st = stamped(*ins, **kw)
        assert (scan.launches, scan.launches_bf16) == counts
        want = scan(*ins, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), tag
        assert st["blocks"] and st["grid"] >= 1
        for b in st["blocks"]:
            assert 0.99 <= sum(b["share"].values()) <= 1.0 + 1e-9, tag


@pytest.mark.cuda
def test_tfm_tensor_core_variant_runs_uncounted_on_the_card():
    """On the card: the measurement entry of B3 with its bf16 products on
    the tensor cores (tfm_beam_bf16_mma, tools/tfm_beam_mma.py) decodes the
    shipped width, counts no launch, agrees with the plain version at T 1
    on >= 99% of rows (bf16 gate (b)), gives the rows of a smaller batch
    bitwise, and raises on f32 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch.ops import tfm_beam_kernel
    dev = torch.device("cuda")
    cases = {tag: (plain, inputs) for tag, _, _, plain, inputs, _ in
             _beam_cases(dev)}
    plain, inputs = cases[f"B3 {torch.bfloat16}"]
    counts = (tfm_beam_kernel.beam_scan_tfm.launches,
              tfm_beam_kernel.beam_scan_tfm.launches_bf16)
    outs = {}
    for B in (1001, 37):
        ins, dims = inputs(B)
        kw = dict(T=1, K=5, V=24, min_length=1, n_best=1, **dims)
        got = tfm_beam_kernel.beam_scan_tfm_mma(*ins, **kw)
        ref = plain(*ins, **kw)
        torch.cuda.synchronize()
        same = ((got[0] == ref[0]).all(dim=(1, 2))
                & (got[1] == ref[1]).all(dim=(1, 2)))
        assert same.float().mean().item() >= 0.99, B
        assert torch.isfinite(got[3]).all()
        outs[B] = got
    assert all(torch.equal(a[:37], b) for a, b in zip(outs[1001], outs[37]))
    assert (tfm_beam_kernel.beam_scan_tfm.launches,
            tfm_beam_kernel.beam_scan_tfm.launches_bf16) == counts
    ins32, dims32 = cases[f"B3 {torch.float32}"][1](37)
    with pytest.raises(NotImplementedError):
        tfm_beam_kernel.beam_scan_tfm_mma(*ins32, T=1, K=5, V=24,
                                          min_length=1, n_best=1, **dims32)
