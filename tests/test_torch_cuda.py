"""Tests of the port's CUDA kernels that need the card (marker ``cuda``;
they skip without one). This file imports torch and the port only (one
test reads chip_smoke.py's bf16 gate), so it runs on a machine without
jax:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import contextlib
import os
import runpy

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
        hs, res = t_gk.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=g, device=dev)
        dgi, dghn, _ = t_gk.gru_seq_bwd(p["wh"], h0, hs, res, dhs)
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
            hs2, _ = t_gk.gru_seq_fwd(wh, bh, gi.contiguous(), h0)
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


@pytest.mark.cuda
def test_backward_recurrence_matches_both_plain_versions_on_the_card():
    """On the card: the backward recurrence from the training forward's
    residual tape against its plain version given the same residuals and
    against the full recompute (dgi and dh0 within 1e-3 of their largest
    entry), the residuals within 1e-4 of the plain forward's, at the
    scope's edges (H 1, H 128, T 1, a batch that is no multiple of the
    rows per block, a batch over many row tiles), bitwise repeatable, one
    launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(5)
    for H, B, T_ in ((1, 33, 25), (t_gk.MAX_H, 37, 25), (102, 37, 1),
                     (80, 1037, 25), (t_gk.MAX_H, 5, 1)):
        p = t_gru.init_gru_params(g, 16, H, dev)
        xs = torch.randn((B, T_, 16), generator=g, device=dev)
        h0 = 0.5 * torch.randn((B, H), generator=g, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs, res = t_gk.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        _, res_ref = t_gk.gru_seq_res_reference(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=g, device=dev)
        before = t_gk.gru_seq_bwd.launches
        runs = [t_gk.gru_seq_bwd(p["wh"], h0, hs, res, dhs)
                for _ in range(2)]
        chain = t_gk._bwd_chain_reference(p["wh"], h0, hs, res, dhs)
        _, _, dgi_r, dh0_r = t_gk.gru_seq_bwd_reference(
            p["wh"], p["bh"], gi, h0, hs, dhs)
        torch.cuda.synchronize()
        assert t_gk.gru_seq_bwd.launches == before + 2
        assert (res - res_ref).abs().max().item() <= 1e-4
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        for got, want in zip(runs[0], chain):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
        for got, want in zip((runs[0][0], runs[0][2]), (dgi_r, dh0_r)):
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
def test_bf16_scan_and_backward_match_plain_versions_on_the_card():
    """On the card: the bf16 scan (with its tape and without) and backward
    on the tensor cores against their plain versions (the backward on the
    kernel's own tape, and the recompute) under chip_smoke.py's [13d]
    gates, at small shapes and the scope's edges (H 1, 16, 102, an odd H
    127; batches that are no multiple of the rows a block, one batch over
    many row tiles), two runs and the tape-less hs bitwise equal, the
    first rows of the larger batch equal to a run on those rows alone,
    one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    bf16_gate = runpy.run_path(
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"),
        run_name="chip_smoke_gates")["bf16_gate"]
    g = torch.Generator(device=dev).manual_seed(20)
    for H, B, T_ in ((1, 3, 4), (16, 5, 7), (102, 37, 6), (127, 9, 5),
                     (80, 2100, 3)):
        p = t_gru.init_gru_params(g, H, H, dev)
        wh, bh = p["wh"].to(bf), p["bh"].to(bf)
        gi = torch.randn((T_, B, 3 * H), generator=g, device=dev).to(bf)
        h0 = (0.5 * torch.randn((B, H), generator=g, device=dev)).to(bf)
        dhs = torch.randn((T_, B, H), generator=g, device=dev).to(bf)
        f0, b0 = t_gk.gru_seq_fwd.launches_bf16, t_gk.gru_seq_bwd.launches_bf16
        fwd = [t_gk.gru_seq_fwd(wh, bh, gi, h0) for _ in range(2)]
        hs, res = fwd[0]
        bwd = [t_gk.gru_seq_bwd(wh, h0, hs, res, dhs) for _ in range(2)]
        nores = t_gk.gru_seq_fwd(wh, bh, gi, h0, residuals=False)[0]
        head = t_gk.gru_seq_fwd(wh, bh, gi[:, :2].contiguous(),
                                h0[:2].contiguous())
        head_b = t_gk.gru_seq_bwd(wh, h0[:2].contiguous(), head[0], head[1],
                                  dhs[:, :2].contiguous())
        hs_p, res_p = t_gk.gru_seq_res_reference(wh, bh, gi, h0)
        chain = t_gk._bwd_chain_reference(wh, h0, hs, res, dhs)
        recomp = t_gk._bwd_recurrence_reference(wh, bh, gi, h0, hs, dhs)
        torch.cuda.synchronize()
        assert t_gk.gru_seq_fwd.launches_bf16 == f0 + 4
        assert t_gk.gru_seq_bwd.launches_bf16 == b0 + 3
        names = ("dgi", "dghn", "dh0")
        bf16_gate(
            f"H {H} B {B} T {T_}",
            [("hs", hs, hs_p), ("res", res, res_p)]
            + [(n, a, b) for n, a, b in zip(names, bwd[0], chain)]
            + [(n + " (recompute)", a, b)
               for n, a, b in zip(names, bwd[0], recomp)],
            {"hs", *names, *(n + " (recompute)" for n in names)})
        assert all(torch.equal(a, b) for a, b in zip(*fwd))
        assert all(torch.equal(a, b) for a, b in zip(*bwd))
        assert torch.equal(nores, hs)
        assert torch.equal(head[0], hs[:, :2])
        assert torch.equal(head[1], res[:, :2])
        assert all(torch.equal(a, b[:2] if b.dim() == 2 else b[:, :2])
                   for a, b in zip(head_b, bwd[0]))


@pytest.mark.cuda
def test_mmd_value_counter_resets_over_interleaved_batches_on_the_card():
    """On the card: B5's value is one launch whose last block resets its
    completion counter, so 200 calls interleaving N 32 and 2 (one block)
    with N 37 and 1,024 (many) give each N's value bitwise equal call to
    call, within 1e-5 of the plain version, and one counter per device and
    stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only there)")
    from controlled_peptide_generation_tpu_torch.ops import mmd_kernel
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    pairs = {N: (torch.randn((N, 100), generator=g, device=dev),
                 torch.randn((N, 100), generator=g, device=dev))
             for N in (32, 37, 1024, 2)}
    vals = {N: [] for N in pairs}
    for _ in range(50):
        for N, (z1, z2) in pairs.items():
            vals[N].append(mmd_kernel.mmd_full_fwd(z1, z2, 7.0))
    torch.cuda.synchronize()
    for N, v in vals.items():
        v = torch.stack(v)
        assert bool((v == v[0]).all())
        want = mmd_kernel.mmd_full_reference(*pairs[N], 7.0).item()
        assert abs(v[0].item() - want) <= 1e-5
    dev = pairs[32][0].device                  # with its index, as calls
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = mmd_kernel._counter(dev, stream)
    assert count.item() == 0
    assert mmd_kernel._counter(dev, stream) is count
    side = torch.cuda.Stream(dev)
    assert mmd_kernel._counter(dev, side.cuda_stream) is not count


def _first_rows(a, n, B):
    """The first B rows of every tensor of ``a`` (nested in lists and
    tuples) whose leading dimension is the batch n; others as they are."""
    if isinstance(a, (list, tuple)):
        return type(a)(_first_rows(x, n, B) for x in a)
    return a[:B] if torch.is_tensor(a) and a.shape[:1] == (n,) else a


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

            # the kernel inputs of the largest batch; a smaller batch takes
            # the first rows of each batch-indexed one (inputs made anew
            # from fewer rows differ in their last bits: cuBLAS sums a
            # product of another row count in another order, and a draw of
            # fewer rows is not a prefix of a larger draw on the card)
            gz = torch.Generator(device=dev).manual_seed(1)
            z_all = torch.randn((2500, model.z_dim), generator=gz, device=dev)
            c_all = model.sample_c_prior(gz, 2500, device=dev)
            ins_all, dims = beam.decode_inputs(model, p, z_all, c_all)

            def inputs(B, ins_all=ins_all, dims=dims):
                return _first_rows(ins_all, 2500, B), dims

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
