#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. device: CUDA is required; prints the card's name and power limit;
2. build: compiles the GRU beam kernel (csrc/beam_gru.cu) with nvcc;
3. kernel vs its plain torch version at the shipped width (V 24, H 102,
   T 25, K 5, n_best 1, fp32, seeded weights) for B in {1, 37, 2500,
   5000, 6144, 12288}: >= 99% of rows with identical token/pointer tapes;
   on the agreeing rows adv and fin_cnt equal and the sc tape and final
   scores within 1e-3 of each other; and exact batch
   invariance (the first 2500 rows at B = 12288 equal B = 2500 bitwise);
   the same agreement at the edges of the kernel's scope (SCOPE_CASES);
4. the main path: the CLaSS pipeline (pipeline.run_from_states, what
   sample_pipeline runs after its file reads) on a run dir holding a
   seeded full-width checkpoint written by the port's saver, with a
   synthetic latent corpus; mogQ with 100 diag components, rounds of 5000
   until 100 unique accepted, in decode modes "all" and "accepted"; the
   kernel's launch count must rise; one round with the kernel and one with
   the plain version (plain=True) on the same draws must agree;
5. prints times beside the card's name and power limit, a `kernels` JSON
   line, and as the last line {"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
V, H, T, K = 24, 102, 25, 5
BATCHES = (1, 37, 2500, 5000, 6144, 12288)
# (T, K, V, H, min_length, n_best) beyond the shipped width
SCOPE_CASES = ((25, 5, 24, 102, 4, 3), (10, 3, 13, 14, 4, 3),
               (25, 10, 128, 127, 1, 1), (2, 126, 128, 127, 1, 2))
MIN_SAME_ROWS = 0.99
MAX_SCORE_DELTA = 1e-3
ROUND_REPS = 21          # host-clock round timings: the host's CPU is shared
FP32_PEAK = 67e12        # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s, NVIDIA data sheet


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    from controlled_peptide_generation_tpu_torch.ops import beam, beam_kernel
    from controlled_peptide_generation_tpu_torch.train import checkpoints
    from controlled_peptide_generation_tpu_torch.utils import runtime

    # ---- 1. device ------------------------------------------------------
    dev = runtime.setup("cuda")
    card = card_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    beam_kernel.build()
    log(f"[2] built csrc/beam_gru.cu in {time.perf_counter() - t0:.2f}s")
    for line in beam_kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
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
    times = {}
    for B in (2500, 5000):
        ins = scan_inputs(B)
        times[B] = (
            cuda_ms(lambda: beam_kernel.beam_scan_gru(*ins, **kw), 20),
            cuda_ms(lambda: beam_kernel.beam_scan_gru_reference(*ins, **kw),
                    5),
            bound_ms(B))
    del outs

    # ---- 4. main path -----------------------------------------------------
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
    # a first decode-all run warms up CUDA and the libraries; its numbers
    # are not kept
    for label in ("warm-up", "all", "accepted"):
        mode = "all" if label == "warm-up" else label
        cfg, args, _ = C.parse_and_finalize(
            flags + ["--hw.decode_mode", mode, "--Q_n_components", "100",
                     "--Q_covariance_type", "diag",
                     "--n_samples_per_round", "5000", "--n_samples_acc",
                     "100", "--samples_outfn_prefix", f"smoke_{label}"],
            extra_args=sample_pipeline.EXTRA_ARGS)
        beam_kernel.beam_scan_gru.launches = 0
        stem, samples, stats = pipeline.run_from_states(
            cfg, args, model, params, vocab, states, device=dev)
        n_launches = beam_kernel.beam_scan_gru.launches
        if n_launches < 1:
            raise AssertionError(f"{label} run: the main path never "
                                 f"launched the beam kernel")
        peps = samples["peptide"]
        acc = np.asarray(samples["accept"], bool)
        n_acc_unique = len({p for p, a in zip(peps, acc) if a})
        if n_acc_unique < 100 or len(set(peps)) != len(peps):
            raise AssertionError(f"{label} run: {n_acc_unique} "
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
            raise AssertionError(f"{label} run: malformed sample columns")
        log(f"[4] {label} run, decode_mode={mode}: {stats['rounds']} "
            f"round(s) consumed, "
            f"{stats['rounds_launched']} launched, {stats['candidates']} "
            f"candidates, {stats['accepted_z']} accepted by the test, "
            f"{n_acc_unique} unique accepted kept, kernel launches "
            f"{n_launches}, beam canary passed, loop "
            f"{stats['seconds']:.4f}s, files {stem}.*")
        if label != "warm-up":
            launches[mode], loop[mode] = n_launches, stats

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
    log(f"[4] same draws, kernel vs plain version: accept masks identical, "
        f"token rows identical {rows_same:.6f}")
    if rows_same < MIN_SAME_ROWS:
        raise AssertionError(f"only {rows_same:.4f} token rows identical")

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

    # ---- 5. report --------------------------------------------------------
    for B, (k_ms, p_ms, (b_ms, _)) in times.items():
        log(f"[5] beam scan B={B}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms ({card})")
    for mode in ("all", "accepted"):
        st = loop[mode]
        q1, med, q3 = round_ms[mode]
        log(f"[5] round of 5000 candidates, decode_mode={mode}: {med:.3f} "
            f"ms (median of {ROUND_REPS}, quartiles {q1:.3f}-{q3:.3f}, host "
            f"clock) ({card}); loop {st['seconds']:.4f} s over "
            f"{st['rounds']} consumed round(s), {st['rounds_launched']} "
            f"launched: too short a window for an accepted-samples/s "
            f"metric")
    k_ms, p_ms, (b_ms, b_by) = times[5000]
    print(json.dumps({"kernels": [{
        "name": "beam_scan_gru",
        "route": "cuda",
        "source": "controlled_peptide_generation_tpu_torch/csrc/beam_gru.cu",
        "replaces": "controlled_peptide_generation_tpu/ops/pallas_beam.py:285",
        "launches": launches["all"] + launches["accepted"],
        "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
