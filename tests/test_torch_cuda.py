"""Tests of the port's CUDA kernels that need the card (marker ``cuda``;
they skip without one). This file imports torch and the port only, so it
runs on a machine without jax:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import contextlib

import pytest
import torch

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
            with t_gk.plain() if plain else contextlib.nullcontext():
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
