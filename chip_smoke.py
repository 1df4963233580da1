#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles the GRU beam kernel (csrc/beam_gru.cu) and the GRU
   training recurrence kernels (csrc/gru_seq.cu) with nvcc, one process
   per source, started together before torch is imported, so the imports
   and the device's start-up run meanwhile; prints ptxas' registers and
   spills;
3. beam kernel vs its plain torch version at the shipped width (V 24,
   H 102, T 25, K 5, n_best 1, fp32, seeded weights) for B in {1, 37,
   2500, 5000, 6144, 12288}: >= 99% of rows with identical token/pointer
   tapes; on the agreeing rows adv and fin_cnt equal and the sc tape and
   final scores within 1e-3 of each other; exact batch invariance (the
   first 2500 rows at B = 12288 equal B = 2500 bitwise); the same
   agreement at the edges of the kernel's scope (SCOPE_CASES);
4. the GRU recurrence kernels (forward, backward, weight gradient) vs
   their plain versions at the encoder and decoder widths (in 150, H 80;
   in 252, H 102), T 25, B in B2_BATCHES, and at the scope edges
   (B2_SCOPE_CASES): hs within 1e-4, each gradient within 1e-3 of its
   largest entry, the backward bitwise repeatable; at B 32 of each width,
   gru_scan through autograd in both directions against the same scan
   inside gru_kernel.plain(), all six gradients;
5. the CLaSS main path: the pipeline (pipeline.run_from_states, what
   sample_pipeline runs after its file reads) on a run dir holding a
   seeded full-width checkpoint written by the port's saver, with a
   synthetic latent corpus; mogQ with 100 diag components, rounds of 5000
   until 100 unique accepted, in decode modes "all" and "accepted"; the
   beam kernel's launch count must rise; one round with the kernel and one
   with the plain version (plain=True) on the same draws must agree;
6. the training main path: ``main.main --phase 1 --dataset amp`` at the
   shipped width and batch 32 for 301 steps: the GRU kernels launched 3
   times per step each (plus the heldout forwards), finite losses, recon
   falling, checkpoints at 150 and 300 reloading with their Adam moments,
   vae_gen.txt over the vocab; then one step from the same params, batch
   and draws through the kernels and inside gru_kernel.plain() must agree;
7. prints times beside the card's name and power limit (kernels, their
   plain versions and bounds, cuDNN's GRU, the cuBLAS product that the
   weight-gradient kernel computes, train steps/s, seconds per phase), a
   `kernels` JSON line, and as the last line {"ok": true, "device":
   {...}}.
"""

import contextlib
import json
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
V, H, T, K = 24, 102, 25, 5
BATCHES = (1, 37, 2500, 5000, 6144, 12288)
# (T, K, V, H, min_length, n_best) beyond the shipped width
SCOPE_CASES = ((25, 5, 24, 102, 4, 3), (10, 3, 13, 14, 4, 3),
               (25, 10, 128, 127, 1, 1), (2, 126, 128, 127, 1, 2))
MIN_SAME_ROWS = 0.99
MAX_SCORE_DELTA = 1e-3
# B2: (input width, H) of the encoder and the decoder at the shipped width
B2_WIDTHS = ((150, 80), (252, 102))
B2_BATCHES = (1, 5, 32, 37, 256, 1024, 4096)
B2_SCAN_BATCH = 32       # gru_scan through autograd: the training batch
# (in, H, B, T) at the edges of the kernels' scope: one step, the largest
# H, batches that are no multiple of the rows per block
B2_SCOPE_CASES = ((252, 102, 37, 1), (16, 128, 37, 25), (16, 128, 5, 1),
                  (8, 1, 33, 25))
MAX_HS_DELTA = 1e-4      # sequential FMAs against cuBLAS sums
MAX_GRAD_REL = 1e-3      # of each gradient tensor's largest entry
TRAIN_ITERS = 300
ROUND_REPS = 21          # host-clock round timings: the host's CPU is shared
FP32_PEAK = 67e12        # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s, NVIDIA data sheet


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Device ms per call of fn by CUDA events. A spin kernel holds the
    stream while the host queues the reps, so the card runs them back to
    back and the host's launch overhead enters the reading only where the
    host needs longer per call than the card (the plain versions)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz for 1.5x the host's time to queue the reps
    torch.cuda._sleep(int(2e9 * min(1.5 * reps * host_s + 1e-3, 2.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(B):
    """Least time for the beam scan at batch B: fp32 FMAs of the GRU and
    head products over the fp32 peak, against inputs read once and tapes
    written once over the HBM rate."""
    flops = B * K * T * 2 * (H * 3 * H + H * V)
    n_in = V * 3 * H + B * 3 * H + H * 3 * H + 3 * H + H * V + V + B * H
    n_out = 3 * B * T * K + B * K + 2 * B
    t_ops, t_bytes = flops / FP32_PEAK, 4 * (n_in + n_out) / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def b2_bound_ms(kind, T_, B, H):
    """Least time of a B2 kernel at these shapes: the larger of its fp32
    FMAs over the fp32 peak and its inputs read once plus outputs written
    once over the HBM rate. fwd: the recurrent product per step (2 B 3H^2
    FLOP), gi/wh/bh/h0 in, hs out; bwd: the gate recompute and
    dgh @ wh^T (twice the forward's), gi/wh/bh/h0/hs/dhs in, dgi/dghn/dh0
    out; wgrad: h_{t-1}^T dgh over T*B rows, h0/hs/dgi/dghn in, dwh/dbh
    out."""
    tb, g3 = T_ * B, 3 * H
    if kind == "fwd":
        flops = 2 * tb * H * g3
        words = tb * g3 + H * g3 + g3 + B * H + tb * H
    elif kind == "bwd":
        flops = 4 * tb * H * g3
        words = (tb * g3 + H * g3 + g3 + B * H + 2 * tb * H
                 + tb * g3 + tb * H + B * H)
    else:
        flops = 2 * tb * (H + 1) * g3
        words = B * H + tb * H + tb * g3 + tb * H + H * g3 + g3
    t_ops, t_bytes = flops / FP32_PEAK, 4 * words / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main():
    phase_s = {}
    t_mark = [T_START]

    def mark(name):
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now

    sys.path.insert(0, ROOT)
    from controlled_peptide_generation_tpu_torch.ops import cuda_build

    # ---- 2. build: one nvcc per source, started together before torch is
    # imported; the imports and the device's start-up run while they
    # compile (the kernel modules then load the libraries built here)
    t_build = time.perf_counter()

    def timed_build(source):
        log_ = cuda_build.compile_library(source)[1]
        return time.perf_counter() - t_build, log_

    sources = ("beam_gru.cu", "gru_seq.cu")
    pool = ThreadPoolExecutor(len(sources))
    builds = [pool.submit(timed_build, src) for src in sources]
    pool.shutdown(wait=False)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    mark("1a import torch")
    import numpy as np
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch import pipeline
    from controlled_peptide_generation_tpu_torch import sample_pipeline
    from controlled_peptide_generation_tpu_torch.api import (
        load_trained_model, load_vocab)
    from controlled_peptide_generation_tpu_torch.latent import fused
    from controlled_peptide_generation_tpu_torch.models import decoder
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
        build_model)
    from controlled_peptide_generation_tpu_torch import main as train_main
    from controlled_peptide_generation_tpu_torch.ops import beam, beam_kernel
    from controlled_peptide_generation_tpu_torch.ops import gru as gru_ops
    from controlled_peptide_generation_tpu_torch.ops import gru_kernel
    from controlled_peptide_generation_tpu_torch.ops import losses
    from controlled_peptide_generation_tpu_torch.train import checkpoints
    from controlled_peptide_generation_tpu_torch.train import opt as train_opt
    from controlled_peptide_generation_tpu_torch.train import train_vae
    from controlled_peptide_generation_tpu_torch.utils import runtime

    # ---- 1. device ------------------------------------------------------
    dev = runtime.setup("cuda")
    card = runtime.card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    mark("1b imports and device, the builds running")

    built = [b.result() for b in builds]
    for kernel in (beam_kernel, gru_kernel):
        kernel.build()
    log("[2] built " + " and ".join(
        f"csrc/{src} in {sec:.2f}s" for src, (sec, _) in zip(sources, built))
        + ", from the start of the build")
    mark("2a waiting for the builds")
    for _, nvcc_log in built:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line or "registers" in line or (
                    "spill" in line):
                log(f"    ptxas: {line.strip()}")

    # ---- run dir: seeded full-width checkpoint + amp vocab ----------------
    run_top = os.path.join(ROOT, "build", "chip_smoke_run")
    flags = ["--savepath_toplevel", run_top, "--runname", "smoke",
             "--vae.n_iter", "1", "--seed", "1238"]
    cfg, _, _ = C.parse_and_finalize(flags)
    vocab = load_vocab(os.path.join(ROOT, "data", "amp", "vocab.dict"))
    vocab.save(os.path.join(cfg.savepath, "vocab.dict"))
    init = build_model(cfg.model, vocab.size(), cfg.max_seq_len).init_params(
        torch.Generator().manual_seed(cfg.seed))
    ckpt = os.path.join(cfg.savepath, "model_1.npz")
    checkpoints.save(ckpt, init)
    model, params = load_trained_model(ckpt, vocab.size(), cfg, device=dev)
    if (model.n_vocab, model.h_dec, model.max_seq_len) != (V, H, T):
        raise AssertionError("the smoke run expects the shipped width")

    mark("2b run dir and checkpoint")

    # ---- 3. kernel vs plain --------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    n_max = max(BATCHES)
    z_all = torch.randn((n_max, model.z_dim), generator=g, device=dev)
    c_all = model.sample_c_prior(g, n_max, device=dev)
    dec = params["dec"]

    def scan_inputs(B):
        tok_table, zc_gi = decoder.step_tables(dec, params["emb"],
                                               z_all[:B], c_all[:B])
        zc0 = model.init_decoder_hidden(params, z_all[:B], c_all[:B])
        return (tok_table, zc_gi, dec["gru"]["wh"], dec["gru"]["bh"],
                dec["out"]["w"], dec["out"]["b"], zc0)

    def compare(ins, kw, what):
        """Kernel vs plain version on the same inputs: every tape. A row
        agrees when its token and pointer tapes are identical; on those
        rows adv and fin_cnt must be equal and the per-step sc tape and
        the final scores within MAX_SCORE_DELTA. Returns the kernel's
        tapes and the max delta on the agreeing rows."""
        B = ins[1].shape[0]
        got = beam_kernel.beam_scan_gru(*ins, **kw)
        ref = beam_kernel.beam_scan_gru_reference(*ins, **kw)
        torch.cuda.synchronize()
        same = ((got[0] == ref[0]).all(dim=(1, 2))
                & (got[1] == ref[1]).all(dim=(1, 2)))
        share_same = same.float().mean().item()
        if not same.any():
            raise AssertionError(f"kernel agrees on no row ({what})")
        # sc is read only on live steps (t < adv: finalization keys finished
        # hypotheses, ys == EOS, by it); once a sentence is done its sc stays
        # ungated while its hidden state advances unseen, so a near-tie
        # there shows in no other tape and is not held. Live entries at the
        # -1e20 blocking scale (fp32 spacing ~1e13 there) must be blocked on
        # both sides; the delta limit holds on the others.
        live = (torch.arange(kw["T"], device=dev)[None, :]
                < ref[4][:, None])[same]
        sc_got, sc_ref = got[2][same][live], ref[2][same][live]
        blocked = sc_ref <= beam_kernel.NEG / 2
        blocked_eq = torch.equal(sc_got <= beam_kernel.NEG / 2, blocked)
        sc_delta = ((sc_got - sc_ref).abs()[~blocked].max().item()
                    if not blocked.all() else 0.0)
        done_delta = ((got[2] - ref[2]).abs()[same][~live].max().item()
                      if not live.all() else 0.0)
        delta = (got[3] - ref[3]).abs()[same].max().item()
        adv_eq = torch.equal(got[4][same], ref[4][same])
        fin_eq = torch.equal(got[5][same], ref[5][same])
        uniq = []
        for tapes in (got, ref):
            top1 = beam.hyps_from_tapes(tapes, 1)[0][:, 0].cpu().numpy()
            uniq.append(len(set(pipeline.canonical_keys(top1))) / B)
        log(f"[3] {what}: rows differing {1 - share_same:.6f}; on agreeing "
            f"rows max |scores delta| {delta:.3e}, max |sc tape delta| on "
            f"live steps {sc_delta:.3e} (blocked entries "
            f"{int(blocked.sum())}, same {blocked_eq}; done steps, not "
            f"held: {done_delta:.3e}), adv equal {adv_eq}, fin_cnt equal "
            f"{fin_eq}; "
            f"uniq ratio kernel {uniq[0]:.4f} plain {uniq[1]:.4f}; plan "
            f"(sentences/block, threads, weights in smem, smem bytes) "
            f"{beam_kernel.launch_plan(B, kw['K'], kw['V'], kw['H'])}")
        if (share_same < MIN_SAME_ROWS or delta > MAX_SCORE_DELTA
                or sc_delta > MAX_SCORE_DELTA or not blocked_eq
                or not adv_eq or not fin_eq):
            raise AssertionError(
                f"kernel disagrees with its plain version ({what}): "
                f"{share_same:.4f} identical rows (need {MIN_SAME_ROWS}), "
                f"max scores delta {delta:.3e} and sc delta {sc_delta:.3e} "
                f"(limit {MAX_SCORE_DELTA}), blocked sc entries same "
                f"{blocked_eq}, adv equal {adv_eq}, fin_cnt equal {fin_eq}")
        return got, max(delta, sc_delta)

    kw = dict(T=T, K=K, V=V, H=H, min_length=1, n_best=1)
    max_err = 0.0
    outs = {}
    for B in BATCHES:
        outs[B], delta = compare(scan_inputs(B), kw, f"B={B}")
        max_err = max(max_err, delta)
    for a, b in zip(outs[12288], outs[2500]):
        if not torch.equal(a[:2500], b):
            raise AssertionError("kernel is not batch invariant: rows of "
                                 "B=12288 differ from B=2500")
    log("[3] batch invariance: first 2500 rows of B=12288 == B=2500 "
        "bitwise")
    mark("3a beam batches")
    # the rest of the kernel's scope, on seeded random weights: other beam
    # settings, weights read through the caches (H 127, V 128: too big for
    # shared memory), the widest beam (K = V - 2)
    gs = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, sc):
        return sc * torch.randn(shape, generator=gs, device=dev)

    for t_, k_, v_, h_, ml, nb in SCOPE_CASES:
        B = 512
        ins = (rnd(v_, 3 * h_, sc=0.5), rnd(B, 3 * h_, sc=0.5),
               rnd(h_, 3 * h_, sc=h_ ** -0.5), rnd(3 * h_, sc=0.1),
               rnd(h_, v_, sc=3 * h_ ** -0.5), rnd(v_, sc=0.1),
               rnd(B, h_, sc=1.0))
        compare(ins, dict(T=t_, K=k_, V=v_, H=h_, min_length=ml, n_best=nb),
                f"scope T={t_} K={k_} V={v_} H={h_} min_length={ml} "
                f"n_best={nb} B={B}")
    mark("3b beam scope cases")
    times = {}
    for B in (2500, 5000):
        ins = scan_inputs(B)
        times[B] = (
            cuda_ms(lambda: beam_kernel.beam_scan_gru(*ins, **kw), 20),
            cuda_ms(lambda: beam_kernel.beam_scan_gru_reference(*ins, **kw),
                    5),
            bound_ms(B))
    del outs
    mark("3c beam timings")

    # ---- 4. B2: the GRU recurrence kernels vs their plain versions -------
    gb = torch.Generator(device=dev).manual_seed(2)
    b2_err = {"fwd": 0.0, "bwd": 0.0, "wgrad": 0.0}
    grad_names = ("wi", "bi", "wh", "bh", "xs", "h0")

    def rel_err(got, want):
        return ((got - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()

    def b2_case(I, H, B, T_, what, scan=False):
        """Forward, backward and weight-gradient kernels against their plain
        versions on the same inputs, the backward twice (bitwise equal);
        with ``scan``, gru_scan through autograd too, both directions,
        kernels against gru_kernel.plain()."""
        p = gru_ops.init_gru_params(gb, I, H, dev)
        xs = torch.randn((B, T_, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs = gru_kernel.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        hs_ref = gru_kernel.gru_seq_reference(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=gb, device=dev)
        runs = []
        for _ in range(2):
            dgi, dghn, dh0 = gru_kernel.gru_seq_bwd(p["wh"], p["bh"], gi, h0,
                                                    hs, dhs)
            runs.append(gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
                        + (dgi, dh0))
        ref = gru_kernel.gru_seq_bwd_reference(p["wh"], p["bh"], gi, h0, hs,
                                               dhs)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        e_hs = (hs - hs_ref).abs().max().item()
        errs = {n: rel_err(a, b) for n, a, b in zip(
            ("dwh", "dbh", "dgi", "dh0"), runs[0], ref)}
        b2_err["fwd"] = max(b2_err["fwd"], e_hs)
        b2_err["wgrad"] = max(b2_err["wgrad"], *(
            (a - b).abs().max().item() for a, b in zip(runs[0][:2], ref[:2])))
        b2_err["bwd"] = max(b2_err["bwd"], *(
            (a - b).abs().max().item() for a, b in zip(runs[0][2:], ref[2:])))
        w = torch.randn((B, T_, H), generator=gb, device=dev)
        w_last = torch.randn((B, H), generator=gb, device=dev)
        scan_errs = {}
        for reverse in (False, True) if scan else ():
            res = []
            for plain in (False, True):
                leaves = [p[k].detach().requires_grad_() for k in grad_names[:4]]
                x = xs.detach().requires_grad_()
                h = h0.detach().requires_grad_()
                with gru_kernel.plain() if plain else contextlib.nullcontext():
                    out, last = gru_ops.gru_scan(
                        dict(zip(grad_names, leaves)), x, h, reverse=reverse)
                    loss = (out * w).sum() + (last * w_last).sum()
                    res.append((out.detach(), torch.autograd.grad(
                        loss, leaves + [x, h])))
            e_scan = (res[0][0] - res[1][0]).abs().max().item()
            g_errs = [rel_err(a, b) for a, b in zip(res[0][1], res[1][1])]
            scan_errs["reverse" if reverse else "forward"] = (e_scan,
                                                              max(g_errs))
            if e_scan > MAX_HS_DELTA or max(g_errs) > MAX_GRAD_REL:
                raise AssertionError(
                    f"gru_scan kernels vs gru_kernel.plain() disagree "
                    f"({what}, reverse={reverse}): hs {e_scan:.3e}, grads "
                    f"{dict(zip(grad_names, g_errs))}")
        log(f"[4] {what}: |hs delta| {e_hs:.3e}; backward rel errors "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; backward bitwise repeatable {bitwise}"
            + ("; gru_scan vs gru_kernel.plain() (|hs delta|, max grad rel "
               "error): " + ", ".join(f"{k} {a:.3e} {b:.3e}" for k, (a, b)
                                       in scan_errs.items())
               if scan else "")
            + f"; plan (rows/block, threads, fwd smem, bwd smem) "
            f"{gru_kernel.launch_plan(B, H)}, wgrad (rows/split, splits) "
            f"{gru_kernel.wgrad_plan(T_, B, H)}")
        if (e_hs > MAX_HS_DELTA or max(errs.values()) > MAX_GRAD_REL
                or not bitwise):
            raise AssertionError(
                f"B2 kernels disagree with their plain versions ({what}): "
                f"hs {e_hs:.3e} (limit {MAX_HS_DELTA}), grads {errs} (limit "
                f"{MAX_GRAD_REL} of each tensor's max), bitwise {bitwise}")

    for I, H_ in B2_WIDTHS:
        for B in B2_BATCHES:
            b2_case(I, H_, B, T, f"B2 in {I} H {H_} T {T} B {B}",
                    scan=B == B2_SCAN_BATCH)
    for I, H_, B, T_ in B2_SCOPE_CASES:
        b2_case(I, H_, B, T_, f"B2 scope in {I} H {H_} T {T_} B {B}")
    mark("4a B2 kernels vs plain")

    b2_times = {}
    for B in (32, 1024):
        I, H_ = B2_WIDTHS[1]
        p = gru_ops.init_gru_params(gb, I, H_, dev)
        xs = torch.randn((B, T, I), generator=gb, device=dev)
        h0 = 0.5 * torch.randn((B, H_), generator=gb, device=dev)
        gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous()
        hs = gru_kernel.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
        dhs = torch.randn(hs.shape, generator=gb, device=dev)
        dgi, dghn, _ = gru_kernel.gru_seq_bwd(p["wh"], p["bh"], gi, h0, hs,
                                              dhs)
        args = (p["wh"], p["bh"], gi, h0)
        # the weight gradient as one cuBLAS product: [h_{t-1} | 1]^T dgh
        # gives dwh and, in its last row, dbh
        hprev1 = torch.cat([torch.cat([h0[None], hs[:-1]]).reshape(-1, H_),
                            torch.ones((T * B, 1), device=dev)], 1)
        dgh = torch.cat([dgi[..., :2 * H_], dghn], 2).reshape(-1, 3 * H_)
        lib_w = torch.mm(hprev1.T, dgh)
        wgrad_delta = max((a - b).abs().max().item() for a, b in zip(
            gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn),
            (lib_w[:H_], lib_w[H_])))
        kern = {
            "fwd": (lambda: gru_kernel.gru_seq_fwd(*args),
                    lambda: gru_kernel.gru_seq_reference(*args)),
            "bwd": (lambda: gru_kernel.gru_seq_bwd(*args, hs, dhs),
                    lambda: gru_kernel._bwd_recurrence_reference(*args, hs,
                                                                 dhs)),
            "wgrad": (lambda: gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn),
                      lambda: gru_kernel._wgrad_reference(h0, hs, dgi,
                                                          dghn)),
        }
        # cuDNN: one torch.nn.GRU call on the same [B, T, in] inputs with
        # the weights transposed (it includes the input projection), and
        # the port's gru_scan with its projection, for a like-for-like read
        cudnn = torch.nn.GRU(I, H_, batch_first=True).to(dev)
        with torch.no_grad():
            for name, src in (("weight_ih_l0", p["wi"].T),
                              ("weight_hh_l0", p["wh"].T),
                              ("bias_ih_l0", p["bi"]),
                              ("bias_hh_l0", p["bh"])):
                getattr(cudnn, name).copy_(src)
            lib_out = cudnn(xs, h0[None])[0]
            scan_out = gru_ops.gru_scan(p, xs, h0)[0]
        lib_delta = (lib_out - scan_out).abs().max().item()
        xg = xs.detach().requires_grad_()
        lib_loss = (cudnn(xg, h0[None])[0] * dhs.transpose(0, 1)).sum()
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        scan_loss = (gru_ops.gru_scan(leaves, xg, h0)[0]
                     * dhs.transpose(0, 1)).sum()

        def fwd_bwd(fn, inputs):
            def run():
                torch.autograd.grad((fn() * dhs.transpose(0, 1)).sum(),
                                    inputs)
            return run

        def no_grad(fn):
            def run():
                with torch.no_grad():
                    fn()
            return run

        b2_times[B] = {
            k: (cuda_ms(a, 50), cuda_ms(b, 5), b2_bound_ms(k, T, B, H_))
            for k, (a, b) in kern.items()}
        b2_times[B]["library"] = {
            "cudnn_fwd": cuda_ms(no_grad(lambda: cudnn(xs, h0[None])), 20),
            "cudnn_bwd": cuda_ms(lambda: torch.autograd.grad(
                lib_loss, [xg] + list(cudnn.parameters()),
                retain_graph=True), 20),
            "cudnn_fwd_bwd": cuda_ms(fwd_bwd(
                lambda: cudnn(xg, h0[None])[0],
                [xg] + list(cudnn.parameters())), 20),
            "scan_fwd": cuda_ms(no_grad(lambda: gru_ops.gru_scan(p, xs, h0)),
                                20),
            "scan_bwd": cuda_ms(lambda: torch.autograd.grad(
                scan_loss, [xg] + list(leaves.values()), retain_graph=True),
                20),
            "scan_fwd_bwd": cuda_ms(fwd_bwd(
                lambda: gru_ops.gru_scan(leaves, xg, h0)[0],
                [xg] + list(leaves.values())), 20),
            "cudnn_vs_scan_delta": lib_delta,
            "wgrad_mm": cuda_ms(lambda: torch.mm(hprev1.T, dgh), 50),
            "wgrad_mm_delta": wgrad_delta}
    mark("4b B2 timings")

    # ---- 5. main path: the CLaSS round ------------------------------------
    rng = np.random.default_rng(4)
    states = {}
    for split, n in (("train", 5000), ("test", 1000)):
        mu = 0.5 * rng.standard_normal((n, model.z_dim))
        label = -np.ones((n, 6), np.int64)
        label[:, 0] = mu[:, 0] + 0.25 * rng.standard_normal(n) > 0
        label[:, 1] = mu[:, 1] + 0.25 * rng.standard_normal(n) > 0
        states[split] = {"mu": mu.astype(np.float16),
                         "logvar": np.full((n, model.z_dim), -1.5,
                                           np.float16),
                         "label": label}
    launches = {}
    loop = {}
    for mode in ("all", "accepted"):
        cfg, args, _ = C.parse_and_finalize(
            flags + ["--hw.decode_mode", mode, "--Q_n_components", "100",
                     "--Q_covariance_type", "diag",
                     "--n_samples_per_round", "5000", "--n_samples_acc",
                     "100", "--samples_outfn_prefix", f"smoke_{mode}"],
            extra_args=sample_pipeline.EXTRA_ARGS)
        beam_kernel.beam_scan_gru.launches = 0
        stem, samples, stats = pipeline.run_from_states(
            cfg, args, model, params, vocab, states, device=dev)
        n_launches = beam_kernel.beam_scan_gru.launches
        if n_launches < 1:
            raise AssertionError(f"{mode} run: the main path never "
                                 f"launched the beam kernel")
        peps = samples["peptide"]
        acc = np.asarray(samples["accept"], bool)
        n_acc_unique = len({p for p, a in zip(peps, acc) if a})
        if n_acc_unique < 100 or len(set(peps)) != len(peps):
            raise AssertionError(f"{mode} run: {n_acc_unique} "
                                 f"unique accepted samples (need 100)")
        for ext in (".plain.txt", ".csv", ".pkl"):
            if not os.path.exists(stem + ext):
                raise AssertionError(f"missing {stem + ext}")
        cols = [np.asarray(samples[k], np.float64) for k in samples
                if k not in ("peptide", "accept_z", "accept")]
        if (samples["z"].shape != (len(peps), model.z_dim)
                or not all(np.isfinite(c).all() for c in cols)
                or not set("".join(peps).replace(" ", "")) <= set(
                    vocab.itos[4:])):
            raise AssertionError(f"{mode} run: malformed sample columns")
        log(f"[5] decode_mode={mode}: {stats['rounds']} "
            f"round(s) consumed, "
            f"{stats['rounds_launched']} launched, {stats['candidates']} "
            f"candidates, {stats['accepted_z']} accepted by the test, "
            f"{n_acc_unique} unique accepted kept, kernel launches "
            f"{n_launches}, beam canary passed, loop "
            f"{stats['seconds']:.4f}s, files {stem}.*")
        launches[mode], loop[mode] = n_launches, stats
        mark(f"5 {mode} run")

    # one round, kernel vs its plain version (plain=True), same draws
    Q = pipeline.fitQ_and_test(cfg, pipeline.resolve_QClass("mogQ"),
                               {"n_components": 100, "z_num_samples": 10,
                                "covariance_type": "diag"}, states,
                               device=dev)[0]
    Q.init_attr_classifiers(
        {a: pipeline.build_clfZ(cfg, a, states, device=dev)
         for a in ("amp", "tox")}, {"amp": 1, "tox": 0})
    draws = fused.round_draws(pipeline.round_generator(cfg.seed, 1, dev),
                              Q._sampler()[1], 5000)
    r_kernel = fused.fused_round(model, params, draws, Q)
    r_plain = fused.fused_round(model, params, draws, Q, plain=True)
    if not torch.equal(r_kernel[2], r_plain[2]):
        raise AssertionError("accept masks differ between the routes")
    rows_same = (r_kernel[3] == r_plain[3]).all(dim=1).float().mean().item()
    log(f"[5] same draws, kernel vs plain version: accept masks identical, "
        f"token rows identical {rows_same:.6f}")
    if rows_same < MIN_SAME_ROWS:
        raise AssertionError(f"only {rows_same:.4f} token rows identical")
    mark("5 kernel vs plain round")

    round_ms = {}
    for mode, cap in (("all", None), ("accepted", 2500)):
        def one_round():
            d = fused.round_draws(pipeline.round_generator(cfg.seed, 2, dev),
                                  Q._sampler()[1], 5000)
            out = fused.fused_round(model, params, d, Q, capacity=cap)
            torch.cuda.synchronize()
            return out
        one_round()
        ts = []
        for _ in range(ROUND_REPS):
            t0 = time.perf_counter()
            one_round()
            ts.append(1e3 * (time.perf_counter() - t0))
        round_ms[mode] = statistics.quantiles(ts, n=4)   # q1, median, q3
    mark("5 round timings")

    # ---- 6. main path: phase-1 training ------------------------------------
    train_top = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(train_top, ignore_errors=True)
    tflags = ["--phase", "1", "--dataset", "amp", "--datapath",
              os.path.join(ROOT, "data"), "--savepath_toplevel", train_top,
              "--tb_toplevel", os.path.join(train_top, "tb"), "--runname",
              "smoke", "--seed", "1238", "--vae.n_iter", str(TRAIN_ITERS),
              "--vae.cheaplog_every", "100", "--vae.expsvlog_every", "150"]
    gru_kernel.reset_launches()
    t0 = time.perf_counter()
    tcfg = train_main.main(tflags)
    train_s = time.perf_counter() - t0
    train_launches = {k: getattr(gru_kernel, f"gru_seq_{k}").launches
                      for k in ("fwd", "bwd", "wgrad")}
    n_steps = TRAIN_ITERS + 1
    ckpts = [it for it in range(1, TRAIN_ITERS + 1)
             if it % tcfg.vae.expsvlog_every == 0]
    # three recurrences per step; the heldout eval at each checkpoint runs
    # the three forwards on each of its 4 batches
    want = {"fwd": 3 * n_steps + 3 * 4 * len(ckpts), "bwd": 3 * n_steps,
            "wgrad": 3 * n_steps}
    if train_launches != want:
        raise AssertionError(f"training launched the B2 kernels "
                             f"{train_launches} times, expected {want}")
    with open(os.path.join(tcfg.savepath, "result.json")) as fh:
        rows = json.load(fh)
    logged = [r for r in rows if "train_L_vae_recon" in r]
    bad = [(r["it"], k) for r in logged for k, v in r.items()
           if k.startswith("train_") and not np.isfinite(v)]
    recon = [r["train_L_vae_recon"] for r in logged]
    if bad or not recon or recon[-1] >= recon[0]:
        raise AssertionError(f"training losses: non-finite {bad}, recon at "
                             f"the logs {recon}")
    final = rows[-1]
    model_t = build_model(tcfg.model, V, tcfg.max_seq_len)
    template = model_t.init_params(torch.Generator(device=dev).manual_seed(0),
                                   dev)
    adam = train_opt.make_optimizer(tcfg.vae)
    for it in ckpts:
        tparams, tstate = checkpoints.load_train_state(
            tcfg.vae.chkpt_path.format(it), template, adam.init(template),
            dev)
        empty = [checkpoints.keystr(k) for k, v in
                 checkpoints.flatten(tstate["nu"]).items()
                 if not v.abs().sum() > 0]
        if int(tstate["count"]) != it + 1 or empty:
            raise AssertionError(f"model_{it}.npz: Adam count "
                                 f"{int(tstate['count'])}, moments empty "
                                 f"for {empty}")
    with open(tcfg.vae.gen_samples_path) as fh:
        gen_lines = fh.read().splitlines()
    if (len(gen_lines) != tcfg.evals.sample_size
            or not set(" ".join(gen_lines).split()) <= set(vocab.itos[4:])):
        raise AssertionError(f"{tcfg.vae.gen_samples_path}: "
                             f"{len(gen_lines)} lines (want "
                             f"{tcfg.evals.sample_size}) or tokens outside "
                             f"the vocab")
    log(f"[6] phase-1 training, {n_steps} steps at batch "
        f"{tcfg.vae.batch_size} (emb {tcfg.model.emb_dim}, encoder H "
        f"{tcfg.model.E_args.h_dim}, z {tcfg.model.z_dim}, decoder H "
        f"{model_t.h_dec}, V {V}, T {tcfg.max_seq_len}): {train_s:.2f} s in "
        f"main.main; B2 launches {train_launches} ({want}); recon at the "
        f"logs {[round(r, 4) for r in recon]}; checkpoints {ckpts} reload "
        f"with Adam count it+1 and nonzero moments; {len(gen_lines)} "
        f"samples in vae_gen.txt; heldout {[(r['it'], r['hld_recon']) for r in rows if 'hld_recon' in r]}")

    mark("6a phase-1 training (main.main) and its checks")
    # one step from the same params, batch and draws: the kernels against
    # the plain step loop
    for leaf in checkpoints.flatten(tparams).values():
        leaf.requires_grad_(True)
    batch = torch.from_numpy(
        train_main.load_dataset(tcfg).next_batch("train_vae").text).to(dev)
    step_draws = train_vae.draw_step(
        model_t, runtime.generator(dev, tcfg.seed, 10 ** 6),
        batch.shape[0], tcfg.max_seq_len, dev)
    rf = losses.init_rf_basis(runtime.generator(dev, tcfg.seed, 7),
                                   model_t.z_dim,
                                   tcfg.losses.wae_mmd.rf_dim, dev)
    loss_fn = train_vae.make_loss_fn(model_t, tcfg.vae, tcfg.losses.wae_mmd,
                                     rf)
    step = [train_vae.loss_and_grads(loss_fn, tparams, batch, 1.5,
                                     step_draws)]
    with gru_kernel.plain():
        step.append(train_vae.loss_and_grads(loss_fn, tparams, batch, 1.5,
                                             step_draws))
    loss_delta = abs(step[0][0].item() - step[1][0].item())
    g_k = checkpoints.flatten(step[0][2])
    g_p = checkpoints.flatten(step[1][2])
    g_errs = {checkpoints.keystr(k): rel_err(g_k[k], g_p[k]) for k in g_k}
    worst = max(g_errs, key=g_errs.get)
    log(f"[6] one train step, kernels vs gru_kernel.plain() on the same "
        f"params, "
        f"batch and draws: loss {step[0][0].item():.6f} vs "
        f"{step[1][0].item():.6f} (|delta| {loss_delta:.3e}); largest "
        f"gradient error {g_errs[worst]:.3e} of the tensor's max ({worst})")
    if loss_delta > MAX_HS_DELTA or g_errs[worst] > MAX_GRAD_REL:
        raise AssertionError("the train step disagrees between the kernels "
                             "and gru_kernel.plain()")
    mark("6b one step, kernels vs plain")

    # ---- 7. report --------------------------------------------------------
    for B, (k_ms, p_ms, (b_ms, _)) in times.items():
        log(f"[7] beam scan B={B}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({card})")
    for mode in ("all", "accepted"):
        st = loop[mode]
        q1, med, q3 = round_ms[mode]
        log(f"[7] round of 5000 candidates, decode_mode={mode}: {med:.3f} "
            f"ms (median of {ROUND_REPS}, quartiles {q1:.3f}-{q3:.3f}, host "
            f"clock) ({card}); loop {st['seconds']:.4f} s over "
            f"{st['rounds']} consumed round(s), {st['rounds_launched']} "
            f"launched: too short a window for an accepted-samples/s "
            f"metric")
    for B, t in b2_times.items():
        for k in ("fwd", "bwd", "wgrad"):
            k_ms, p_ms, (b_ms, b_by) = t[k]
            log(f"[7] B2 {k} at B {B}, T {T}, H {B2_WIDTHS[1][1]}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.6f} ms "
                f"({b_by}), launches per train step 3 ({card})")
        lib = t["library"]
        log(f"[7] B2 at B {B}, in {B2_WIDTHS[1][0]}, H {B2_WIDTHS[1][1]}, "
            f"T {T}, with the input projection: torch.nn.GRU (cuDNN) "
            f"forward {lib['cudnn_fwd']:.4f} ms, backward "
            f"{lib['cudnn_bwd']:.4f} ms, forward+backward "
            f"{lib['cudnn_fwd_bwd']:.4f} ms; the port's gru_scan forward "
            f"{lib['scan_fwd']:.4f} ms, backward {lib['scan_bwd']:.4f} ms, "
            f"forward+backward {lib['scan_fwd_bwd']:.4f} ms; max |hs delta| "
            f"cuDNN vs gru_scan {lib['cudnn_vs_scan_delta']:.3e} ({card})")
        log(f"[7] B2 wgrad at B {B} as one cuBLAS product, torch.mm of "
            f"[h_(t-1) | 1]^T [{T * B}, {B2_WIDTHS[1][1] + 1}] by dgh "
            f"[{T * B}, {3 * B2_WIDTHS[1][1]}] on prebuilt operands: "
            f"{lib['wgrad_mm']:.4f} ms (the kernel {t['wgrad'][0]:.4f} ms "
            f"also gathers its operands); max |delta| against the kernel "
            f"{lib['wgrad_mm_delta']:.3e} ({card})")
    log(f"[7] phase-1 training at the shipped width, batch "
        f"{tcfg.vae.batch_size}: {final['train_steps_per_sec_warm']:.2f} "
        f"steps/s after the first {train_vae.WARM_STEPS} steps, "
        f"{final['train_steps_per_sec']:.2f} steps/s over all {n_steps} "
        f"(host clock, log and checkpoint boundaries included) ({card})")
    k_ms, p_ms, (b_ms, b_by) = times[5000]
    entries = [{
        "name": "beam_scan_gru",
        "route": "cuda",
        "source": "controlled_peptide_generation_tpu_torch/csrc/beam_gru.cu",
        "replaces": "controlled_peptide_generation_tpu/ops/pallas_beam.py:285",
        "launches": launches["all"] + launches["accepted"],
        "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    lib32 = b2_times[32]["library"]
    for k, replaces, lib_ms in (
            ("fwd", "pallas_gru.py:283", lib32["cudnn_fwd"]),
            ("bwd", "pallas_gru.py:312", lib32["cudnn_bwd"]),
            ("wgrad", "pallas_gru.py:206", lib32["wgrad_mm"])):
        k_ms, p_ms, (b_ms, b_by) = b2_times[32][k]
        entries.append({
            "name": f"gru_seq_{k}", "route": "cuda",
            "source": "controlled_peptide_generation_tpu_torch/csrc/"
                      "gru_seq.cu",
            "replaces": f"controlled_peptide_generation_tpu/ops/{replaces}",
            "launches": train_launches[k], "max_abs_err": b2_err[k],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    mark("7 report")
    log("[7] seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in phase_s.items())
        + f"; total {time.perf_counter() - T_START:.2f}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(runtime.card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
