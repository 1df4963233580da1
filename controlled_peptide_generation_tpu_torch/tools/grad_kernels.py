"""B2's bf16 weight gradient and B5's gradient on the card: each against its
plain version, and both timed.

    python -m controlled_peptide_generation_tpu_torch.tools.grad_kernels \
        [--out FILE.json]

Builds csrc/gru_seq.cu and csrc/mmd_full.cu alone (about half a minute),
prints ptxas' registers and spills of the weight-gradient kernels
(``gru_wgrad_kernel<V>``, ``gru_wgrad_mma_kernel<..., bf16>``) and of the
MMD kernels, and fails on a spill of ``gru_wgrad_mma_kernel`` or
``mmd_grad_kernel``. Then, for the weight gradient on the tensor cores
(``gru_seq_wgrad`` in bf16): at T 25, B 32 and 1,024, H 80 and 102, and at
the scope edges (an odd H, 127, which takes plain loads; T*B not a multiple
of the 32-row slice), on dgi and dghn from B2's own bf16 backward of seeded
inputs, the share of its bf16 outputs bitwise equal to the plain version
(``_wgrad_reference``) and the largest delta over the largest entry
(chip_smoke.py's B2_BF16_SAME and B2_BF16_ULPS gates), two runs bitwise
equal. For B5's gradient (``mmd_full_bwd``): the three forms at
chip_smoke.py's B5_NS and B5_EDGES and the CPU tests' tiling edges, the
largest delta over the plain version's largest entry (MAX_MMD_GRAD_REL),
two runs bitwise equal, NaN at N 1. Then CUDA-event times: the kernel,
the plain version and, for the weight gradient, one bf16 ``torch.mm`` of
the prebuilt operands; for B5, the value kernel beside its gradient. With
--out, the readings also go to a JSON file. Exits 1 on any failed gate.
Needs CUDA.

It calls the package's wrappers alone (``gru_seq_wgrad``, ``gru_seq_fwd``,
``gru_seq_bwd``, ``_wgrad_reference``, ``mmd_full_bwd`` and its plain
version), so a copy of this file placed in an older checkout's
``tools/`` and run there times that checkout's kernels on the same seeded
inputs: two checkouts are compared in one call to the card as parent,
change, change, parent. What an older checkout lacks (the plans, the MMD
ptxas report) is printed as None, or by mangled name.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

T = 25
WGRAD_CASES = ((32, 80), (1024, 80), (32, 102), (1024, 102))
WGRAD_EDGES = ((6, 5, 127), (25, 33, 127), (7, 9, 102), (3, 37, 80))
B2_BF16_SAME = 0.99
B2_BF16_ULPS = 2
B5_NS = (2, 5, 32, 37, 256, 1024, 4096)
B5_EDGES = ((2, 1), (37, 1), (1024, 1), (2, 256), (37, 256), (1024, 256),
            (33, 7), (65, 100), (129, 256))
B5_FORMS = ("gaussian", "laplace", "energy")
B5_TIMED = (32, 64, 128, 1024, 4096)
MAX_MMD_GRAD_REL = 1e-4


def wgrad_inputs(gen, dev, T_, B, H):
    """h0, hs, dgi, dghn in bf16 from B2's own bf16 forward and backward
    of seeded inputs at the model's scales."""
    from ..ops import gru as gru_ops
    from ..ops import gru_kernel
    bf = torch.bfloat16
    p = gru_ops.init_gru_params(gen, H, H, dev)
    wh, bh = p["wh"].to(bf), p["bh"].to(bf)
    gi = torch.randn((T_, B, 3 * H), generator=gen, device=dev).to(bf)
    h0 = (0.5 * torch.randn((B, H), generator=gen, device=dev)).to(bf)
    dhs = torch.randn((T_, B, H), generator=gen, device=dev).to(bf)
    hs, res = gru_kernel.gru_seq_fwd(wh, bh, gi, h0)
    dgi, dghn, _ = gru_kernel.gru_seq_bwd(wh, h0, hs, res, dhs)
    return h0, hs, dgi, dghn


def agreement(got, want):
    """(share bitwise equal, max |delta| over the largest |want|)."""
    same = (got == want).float().mean().item()
    delta = (got.float() - want.float()).abs().max().item()
    return same, delta / max(want.float().abs().max().item(), 1e-30)


def optional(fn, *args, **kwargs):
    """fn(*args, **kwargs), or None where this checkout's package has no
    such function or takes no such argument."""
    try:
        return None if fn is None else fn(*args, **kwargs)
    except TypeError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the readings to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from ..ops import cuda_build, gru_kernel, mmd_kernel
    from ..utils import runtime
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for b in [pool.submit(m.build) for m in (gru_kernel, mmd_kernel)]:
            b.result()
    dev = runtime.setup("cuda")
    card = runtime.card_line()
    print(f"device {torch.cuda.get_device_name(0)}; {card}; builds "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mmd_report = getattr(mmd_kernel, "ptxas_report", None)
    usage = {**{k: v for k, v in gru_kernel.ptxas_report().items()
                if k.startswith("gru_wgrad")},
             **(mmd_report() if mmd_report else cuda_build.ptxas_usage(
                 mmd_kernel.build_log, lambda e: e if "mmd_" in e else None))}
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B", flush=True)
    failed = [f"spill in {k}" for k, v in usage.items()
              if (v[1] or v[2]) and k.startswith(("gru_wgrad_mma", "mmd_grad"))]
    # the floor of any launch on this card: one one-element add
    one_elem = torch.zeros((1,), device=dev)
    floor_ms = runtime.cuda_ms(lambda: one_elem.add_(1.0), 200)
    print(f"one launch of a one-element add: {floor_ms:.5f} ms", flush=True)
    out = {"card": card, "ptxas": usage, "wgrad": {}, "mmd": {},
           "floor_ms": floor_ms}
    gen = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16

    # ---- B2's bf16 weight gradient ----------------------------------------
    cases = [(T, B, H) for B, H in WGRAD_CASES] + list(WGRAD_EDGES)
    for T_, B, H in cases:
        h0, hs, dgi, dghn = wgrad_inputs(gen, dev, T_, B, H)
        runs = [gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn) for _ in range(2)]
        ref = gru_kernel._wgrad_reference(h0, hs, dgi, dghn)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        g = {n: agreement(a, b) for n, a, b in
             zip(("dwh", "dbh"), runs[0], ref)}
        ok = bitwise and all(
            s >= B2_BF16_SAME and d <= B2_BF16_ULPS * 2.0 ** -8
            for s, d in g.values()) and all(a.dtype == bf for a in runs[0])
        rec = {"plan": optional(gru_kernel.wgrad_plan, T_, B, H,
                                bf16=True),
               "gates": g, "bitwise": bitwise}
        if (B, H) in WGRAD_CASES and T_ == T:
            hprev1 = torch.cat([torch.cat([h0[None], hs[:-1]]).reshape(
                -1, H), torch.ones((T_ * B, 1), dtype=bf, device=dev)], 1)
            dgh = torch.cat([dgi[..., :2 * H], dghn], 2).reshape(-1, 3 * H)
            rec["ms"] = {
                "kernel": runtime.cuda_ms(lambda: gru_kernel.gru_seq_wgrad(
                    h0, hs, dgi, dghn), 50),
                "plain": runtime.cuda_ms(lambda: gru_kernel._wgrad_reference(
                    h0, hs, dgi, dghn), 5),
                "torch.mm": runtime.cuda_ms(lambda: torch.mm(hprev1.T, dgh),
                                            50)}
        out["wgrad"][f"T {T_} B {B} H {H}"] = rec
        print(f"wgrad bf16 T {T_} B {B} H {H}: plan {rec['plan']}; "
              f"(share bitwise, max delta / largest) {g}; two runs bitwise "
              f"{bitwise}"
              + (f"; ms {rec['ms']}" if "ms" in rec else "") + f" ({card})",
              flush=True)
        if not ok:
            failed.append(f"wgrad T {T_} B {B} H {H}")

    # ---- B5's gradient ----------------------------------------------------
    one = torch.ones((), device=dev)
    for form in B5_FORMS:
        errs = []
        for N, D in [(n, 100) for n in B5_NS] + list(B5_EDGES):
            z1 = 0.8 * torch.randn((N, D), generator=gen, device=dev) + 0.1
            z2 = torch.randn((N, D), generator=gen, device=dev)
            runs = [(mmd_kernel.mmd_full_bwd(z1, z2, one, 7.0, form),
                     mmd_kernel.mmd_full_bwd(z2, z1, one, 7.0, form))
                    for _ in range(2)]
            ref = (mmd_kernel.mmd_full_bwd_reference(z1, z2, 7.0, form),
                   mmd_kernel.mmd_full_bwd_reference(z2, z1, 7.0, form))
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
            rel = max(agreement(a, b)[1] for a, b in zip(runs[0], ref))
            errs.append((N, D, rel, bitwise))
            if rel > MAX_MMD_GRAD_REL or not bitwise:
                failed.append(f"mmd {form} N {N} D {D}: {rel:.3e} "
                              f"bitwise {bitwise}")
            del ref, runs
        z = torch.randn((1, 100), generator=gen, device=dev)
        nan = bool(torch.isnan(mmd_kernel.mmd_full_bwd(z, z + 1, one, 7.0,
                                                       form)).all())
        if not nan:
            failed.append(f"mmd {form} N 1: not NaN")
        out["mmd"][form] = {"errors": errs, "nan_at_1": nan}
        print(f"mmd bwd {form}: (N, D, max delta / largest, bitwise) "
              f"{[(n, d, f'{e:.2e}', b) for n, d, e, b in errs]}; N 1 NaN "
              f"{nan}", flush=True)
        torch.cuda.empty_cache()
    times = {}
    for N in B5_TIMED:
        z1 = 0.8 * torch.randn((N, 100), generator=gen, device=dev) + 0.1
        z2 = torch.randn((N, 100), generator=gen, device=dev)
        reps = 20 if N >= 1024 else 200
        times[N] = {
            "plan": optional(getattr(mmd_kernel, "grad_plan", None), N,
                             100),
            "kernel": runtime.cuda_ms(lambda: mmd_kernel.mmd_full_bwd(
                z1, z2, one, 7.0), reps),
            "value": runtime.cuda_ms(lambda: mmd_kernel.mmd_full_fwd(
                z1, z2, 7.0), reps)}
        print(f"mmd bwd N {N} D 100: {times[N]} ({card})", flush=True)
    out["mmd"]["ms"] = times
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
