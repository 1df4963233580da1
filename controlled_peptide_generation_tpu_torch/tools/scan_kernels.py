"""B2's bf16 scan and backward, and B5's value, on the card: each against
its plain version, and timed.

    python -m controlled_peptide_generation_tpu_torch.tools.scan_kernels \
        [--out FILE.json] [--sass DIR]

Builds csrc/gru_seq.cu and csrc/mmd_full.cu alone (about half a minute)
and prints ptxas' registers and spills of every instantiation of both
sources; a spill in either fails the run. Then, for ``gru_seq_fwd`` (with
its residual tape and without) and ``gru_seq_bwd`` in bf16 at T 25, B 32
and 1,024, H 80 and 102, on seeded inputs at the model's scales: the
share of each bf16 output bitwise equal to its plain version
(``gru_seq_res_reference``; ``_bwd_chain_reference`` on the kernel's own
tape and, for the recompute, ``_bwd_recurrence_reference``) and the
largest delta over the largest entry, held to chip_smoke.py's
``bf16_gate`` (B2_BF16_SAME and B2_BF16_ULPS), two runs bitwise equal,
the tape-less hs equal to the taped one, and batch invariance: a B 32 run
on the first 32 rows of the B 1,024 inputs gives those rows' bits. The
same gates at chip_smoke.py's scope edges (an odd H, 127; batches that
are no multiple of the rows a block) and two more (H 80, H 16).
CUDA-event times of the three entries, the plain versions (a few reps)
and chip_smoke.py's ``b2_bf16_bound_ms`` (the JAX function's bytes).
B5's value (``mmd_full_fwd``) at chip_smoke.py's ``[4m]`` shapes: each
value's bits (to hold two checkouts to the same bits) and its time at
B5_TIMED. With --sass, the count of local-memory instructions (STL, LDL) of each kernel
of both libraries is printed, and cuobjdump's SASS of those that have any
and of the bf16 scan's and backward's instantiations at H 102 goes to
DIR. With
--out, the readings also go to a JSON file. Exits 1 on any failed gate.
Needs CUDA.

It calls the package's wrappers alone (``gru_seq_fwd``, ``gru_seq_bwd``,
their plain versions, ``mmd_full_fwd``), so a copy of this file placed in
an older checkout's ``tools/`` and run there times that checkout's
kernels on the same seeded inputs: two checkouts are compared in one call
to the card as parent, change, change, parent. The gates, bounds and
shapes come from that checkout's own chip_smoke.py. What an older
checkout lacks (the bf16 plan) is printed as None.
"""

import argparse
import json
import os
import re
import runpy
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

# the checkout's chip_smoke.py: [13d]'s gates, bound and shapes, [4m]'s
SMOKE = runpy.run_path(
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chip_smoke.py"),
    run_name="chip_smoke_constants")
T = 25
CASES = tuple((H, I) for I, H in SMOKE["B2_WIDTHS"])   # (H, input width)
BATCHES = SMOKE["B2_BF16_BATCHES"]
EDGES = SMOKE["B2_BF16_WGRAD_EDGES"] + ((3, 37, 80), (1, 3, 16))
B5_NS, B5_EDGES, B5_FORMS = (SMOKE[k] for k in ("B5_NS", "B5_EDGES",
                                               "B5_FORMS"))
B5_TIMED = SMOKE["B5_TIMED_NS"]


def bound_ms(kind, T_, B, H):
    return SMOKE["b2_bf16_bound_ms"](kind, T_, B, H)[0]


def gate(pairs, bf16_names):
    """{name: (share bitwise, max |delta| over the largest |want|)} and
    chip_smoke.py's bf16_gate verdict (empty, or its message)."""
    out = {n: SMOKE["bf16_agreement"](a, b)[:2] for n, a, b in pairs}
    try:
        SMOKE["bf16_gate"]("gates", pairs, bf16_names)
    except AssertionError as e:
        return out, [str(e)]
    return out, []


def inputs(gen, dev, T_, B, H, I):
    """wh, bh, gi, h0, dhs in bf16 at the model's scales (gi from a f32
    projection of seeded x, as the train step makes it)."""
    from ..ops import gru as gru_ops
    bf = torch.bfloat16
    p = gru_ops.init_gru_params(gen, I, H, dev)
    xs = torch.randn((B, T_, I), generator=gen, device=dev)
    gi = (xs @ p["wi"] + p["bi"]).transpose(0, 1).contiguous().to(bf)
    h0 = (0.5 * torch.randn((B, H), generator=gen, device=dev)).to(bf)
    dhs = torch.randn((T_, B, H), generator=gen, device=dev).to(bf)
    return p["wh"].to(bf), p["bh"].to(bf), gi, h0, dhs


def check(wh, bh, gi, h0, dhs):
    """The gates of one shape: returns (outputs, gates, failures)."""
    from ..ops import gru_kernel as gk
    fwd = [gk.gru_seq_fwd(wh, bh, gi, h0) for _ in range(2)]
    hs, res = fwd[0]
    hs_nores = gk.gru_seq_fwd(wh, bh, gi, h0, residuals=False)[0]
    bwd = [gk.gru_seq_bwd(wh, h0, hs, res, dhs) for _ in range(2)]
    hs_p, res_p = gk.gru_seq_res_reference(wh, bh, gi, h0)
    chain = gk._bwd_chain_reference(wh, h0, hs, res, dhs)
    recomp = gk._bwd_recurrence_reference(wh, bh, gi, h0, hs, dhs)
    torch.cuda.synchronize()
    names = ("dgi", "dghn", "dh0")
    g, bad = gate(
        [("hs", hs, hs_p), ("res", res, res_p)]
        + [(n, a, b) for n, a, b in zip(names, bwd[0], chain)]
        + [(n + " (recompute)", a, b)
           for n, a, b in zip(names, bwd[0], recomp)],
        {"hs", *names, *(n + " (recompute)" for n in names)})
    if not (all(torch.equal(a, b) for a, b in zip(*fwd))
            and all(torch.equal(a, b) for a, b in zip(*bwd))):
        bad.append("two runs differ")
    if not torch.equal(hs_nores, hs):
        bad.append("the tape-less hs differs")
    if not all(a.dtype == torch.bfloat16 for a in (hs, *bwd[0])):
        bad.append("dtype")
    return (hs, res, *bwd[0]), g, bad


def optional(fn, *args, **kwargs):
    """fn(*args, **kwargs), or None where this checkout has no such
    function."""
    return None if fn is None else fn(*args, **kwargs)


def time_entries(gk, runtime, wh, bh, gi, h0, dhs, hs, res, reps=50):
    return {
        "fwd": runtime.cuda_ms(lambda: gk.gru_seq_fwd(wh, bh, gi, h0), reps),
        "fwd_nores": runtime.cuda_ms(lambda: gk.gru_seq_fwd(
            wh, bh, gi, h0, residuals=False), reps),
        "bwd": runtime.cuda_ms(lambda: gk.gru_seq_bwd(wh, h0, hs, res, dhs),
                               reps)}


def sass_counts(lib_path, out_dir):
    """{kernel symbol: (STL count, LDL count)} of a built library; the SASS
    of each kernel with local-memory instructions, and of the bf16 scan and
    backward at H 102 (KT 7), is written to out_dir."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    counts, bodies, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name], bodies[name] = [0, 0], []
        elif name:
            bodies[name].append(line)
            counts[name][0] += bool(re.search(r"\bSTL\b", line))
            counts[name][1] += bool(re.search(r"\bLDL\b", line))
    os.makedirs(out_dir, exist_ok=True)
    for k, (st, ld) in counts.items():
        if st or ld or re.search(r"(scan|bwd)_mma_kernelILi7E", k):
            with open(os.path.join(out_dir, k[:120] + ".sass"), "w") as fh:
                fh.write("\n".join(bodies[k]))
    return {k: tuple(v) for k, v in counts.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the readings to this JSON file")
    ap.add_argument("--sass", default=None,
                    help="write both libraries' SASS to this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from ..ops import cuda_build, gru_kernel as gk, mmd_kernel
    from ..utils import runtime
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for b in [pool.submit(m.build) for m in (gk, mmd_kernel)]:
            b.result()
    dev = runtime.setup("cuda")
    card = runtime.card_line()
    print(f"device {torch.cuda.get_device_name(0)}; {card}; builds "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mmd_report = getattr(mmd_kernel, "ptxas_report", None)
    usage = {**gk.ptxas_report(),
             **(mmd_report() if mmd_report else cuda_build.ptxas_usage(
                 mmd_kernel.build_log, lambda e: e if "mmd_" in e else None))}
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B", flush=True)
    failed = [f"spill in {k}" for k, v in usage.items() if v[1] or v[2]]
    out = {"card": card, "ptxas": usage, "b2": {}, "edges": {}, "b5": {}}
    if args.sass:
        for lib in (gk.build(), mmd_kernel.build()):
            counts = sass_counts(lib._name, args.sass)
            local = {k: v for k, v in counts.items() if v != (0, 0)}
            out.setdefault("sass_local", {})[os.path.basename(lib._name)] = \
                local
            print(f"SASS {os.path.basename(lib._name)}: {len(counts)} "
                  f"kernels; (STL, LDL) where not zero: {local}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(20)
    plan = getattr(gk, "bf16_plan", None)

    # ---- B2 in bf16 at the model's shapes -----------------------------------
    for H, I in CASES:
        big = inputs(gen, dev, T, max(BATCHES), H, I)
        full = None
        for B in sorted(BATCHES, reverse=True):
            wh, bh, gi, h0, dhs = big
            if B < max(BATCHES):
                gi, dhs = gi[:, :B].contiguous(), dhs[:, :B].contiguous()
                h0 = h0[:B].contiguous()
            outs, g, bad = check(wh, bh, gi, h0, dhs)
            if full is None:
                full = outs
            else:
                # batch invariance: these rows' bits in the larger run
                inv = all(torch.equal(a, b[:B] if b.dim() == 2 else b[:, :B])
                          for a, b in zip(outs, full))
                if not inv:
                    bad.append(f"rows differ from B {max(BATCHES)}'s")
            hs, res = outs[0], outs[1]
            ms = time_entries(gk, runtime, wh, bh, gi, h0, dhs, hs, res)
            plain = {
                "fwd": runtime.cuda_ms(lambda: gk.gru_seq_res_reference(
                    wh, bh, gi, h0), 3),
                "bwd": runtime.cuda_ms(lambda: gk._bwd_chain_reference(
                    wh, h0, hs, res, dhs), 3)}
            rec = {"plan": optional(plan, B, H), "gates": g, "ms": ms,
                   "plain_ms": plain,
                   "bound_ms": {k: bound_ms(k, T, B, H) for k in ms},
                   "failed": bad}
            out["b2"][f"H {H} B {B}"] = rec
            print(f"b2 bf16 H {H} T {T} B {B}: plan {rec['plan']}; ms "
                  + ", ".join(f"{k} {v:.6f} ({v * 1e3 / T:.3f} us a step)"
                              for k, v in ms.items())
                  + f"; plain {plain}; bound {rec['bound_ms']}; (share "
                  f"bitwise, max delta / largest) "
                  + ", ".join(f"{n} ({s:.5f}, {d:.2e})"
                              for n, (s, d) in g.items())
                  + f"; failed {bad} ({card})", flush=True)
            failed += [f"H {H} B {B}: {b}" for b in bad]
        del big, full
        torch.cuda.empty_cache()
    for T_, B, H in EDGES:
        outs, g, bad = check(*inputs(gen, dev, T_, B, H, H))
        out["edges"][f"T {T_} B {B} H {H}"] = {
            "plan": optional(plan, B, H), "gates": g, "failed": bad}
        print(f"b2 bf16 edge T {T_} B {B} H {H}: plan "
              f"{optional(plan, B, H)}; "
              + ", ".join(f"{n} ({s:.5f}, {d:.2e})" for n, (s, d) in g.items())
              + f"; failed {bad}", flush=True)
        failed += [f"edge T {T_} B {B} H {H}: {b}" for b in bad]

    # ---- B5's value ---------------------------------------------------------
    gb = torch.Generator(device=dev).manual_seed(4)
    vals = {}
    for form in B5_FORMS:
        for N, D in [(n, 100) for n in B5_NS] + list(B5_EDGES):
            z1 = 0.8 * torch.randn((N, D), generator=gb, device=dev) + 0.1
            z2 = torch.randn((N, D), generator=gb, device=dev)
            v = mmd_kernel.mmd_full_fwd(z1, z2, 7.0, form)
            ref = mmd_kernel.mmd_full_reference(z1, z2, 7.0, form)
            vals[f"{form} {N}x{D}"] = (float(v.item()).hex(),
                                       abs(v.item() - ref.item()))
    times = {}
    for N in B5_TIMED:
        z1 = 0.8 * torch.randn((N, 100), generator=gb, device=dev) + 0.1
        z2 = torch.randn((N, 100), generator=gb, device=dev)
        times[N] = runtime.cuda_ms(lambda: mmd_kernel.mmd_full_fwd(
            z1, z2, 7.0), 20 if N >= 1024 else 200)
    out["b5"] = {"values": vals, "ms": times}
    print(f"b5 value bits (value as hex, |delta| against the plain "
          f"version): {vals}", flush=True)
    print(f"b5 value ms at D 100: {times} ({card})", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    print("all gates held", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
