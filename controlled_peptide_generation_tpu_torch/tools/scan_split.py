"""Where B2's bf16 scan and backward spend a step on the card: a clocked
split of ``gru_scan_mma_kernel``'s and ``gru_bwd_mma_kernel``'s phases.

    python -m controlled_peptide_generation_tpu_torch.tools.scan_split

Copies csrc/gru_seq.cu into build/scan_split/, turns the two kernels'
``// [mma split ...]`` markers into reads of the SM clock (clock64) by
the first thread of block 0, which adds each phase's cycles up over its
steps (registers only; one store of the sums at the kernel's end, with
the kernel's span in cycles and in ns of %globaltimer), builds it with
nvcc beside the production build, and runs ``gru_seq_fwd`` (with the
tape) and ``gru_seq_bwd`` through it (the package's wrappers on the
stamped library) at T 25, B 32 and 1,024, H 80 and 102, on seeded bf16
inputs. Prints, per kernel and shape, the stamped launch's CUDA-event
time beside the production kernel's, the plan, the prologue in three
phases (the weights' loads started, their fragments in registers, the
rest up to the first step) and each phase's time a step (us, at the
clock rate the block measured): the next step's loads started, the
products staged, the cells done, the barrier. Needs CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

SHAPES = ((32, 80), (1024, 80), (32, 102), (1024, 102))
# by marker index: the prologue's 5, 6 and 0, then a step's 1-4
PHASES = ("the rest of the prologue", "loads started", "products staged",
          "cells done", "barrier", "weight loads started",
          "weight fragments in")
T = 25


def stamped_source(src):
    """gru_seq.cu with the clock reads at the two kernels' markers (the
    scan's first in the file, kind 0; the backward's, kind 1) and an entry
    that copies the sums out."""
    kind = {"decl": 0, "end": 0}

    def decl(_m):
        kind["decl"] += 1
        return ("  unsigned long long sp_acc_[7] = {0, 0, 0, 0, 0, 0, 0};\n"
                "  long long sp_prev_ = clock64();\n"
                "  const long long sp_c0_ = sp_prev_;\n"
                "  unsigned long long sp_g0_;\n"
                "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                "\"=l\"(sp_g0_));")

    def stamp(m):
        i = int(m.group(1))
        return (f"      {{ const long long t_ = clock64(); sp_acc_[{i}] += "
                f"t_ - sp_prev_; sp_prev_ = t_; }}")

    def end(_m):
        k = kind["end"]
        kind["end"] += 1
        return ("  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
                "    unsigned long long g1_;\n"
                "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                "\"=l\"(g1_));\n"
                + "".join(f"    g_mma_split[{10 * k + i}] = sp_acc_[{i}];\n"
                          for i in range(7))
                + f"    g_mma_split[{10 * k + 7}] = clock64() - sp_c0_;\n"
                f"    g_mma_split[{10 * k + 8}] = g1_ - sp_g0_;\n"
                f"    g_mma_split[{10 * k + 9}] = 1;\n  }}")

    out = re.sub(r"[ ]*// \[mma split decl\]", decl, src)
    out = re.sub(r"[ ]*// \[mma split (\d): [a-z ]+\]", stamp, out)
    out = re.sub(r"[ ]*// \[mma split end\]", end, out)
    if kind["decl"] != 2 or kind["end"] != 2:
        raise RuntimeError(f"split markers in csrc/gru_seq.cu: {kind}")
    decl_g = "__device__ unsigned long long g_mma_split[20];\n"
    out = out.replace("namespace {\n", "namespace {\n" + decl_g, 1)
    return out + ("\nextern \"C\" int gru_seq_mma_split(unsigned long long* "
                  "h) { return (int)cudaMemcpyFromSymbol(h, g_mma_split, "
                  "sizeof(g_mma_split)); }\n")


def main(argv=None):
    if not torch.cuda.is_available():
        print("scan_split: CUDA is not available", file=sys.stderr)
        return 2
    from ..ops import cuda_build, gru_kernel
    from ..utils import runtime
    from .scan_kernels import inputs
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = os.path.join(os.path.dirname(here), "build", "scan_split")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(here, "csrc")
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            with open(os.path.join(csrc, name)) as fh, open(
                    os.path.join(out_dir, name), "w") as out:
                out.write(fh.read())
    with open(os.path.join(csrc, "gru_seq.cu")) as fh:
        src = stamped_source(fh.read())
    cu = os.path.join(out_dir, "gru_seq.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    so = os.path.join(out_dir, "libgru_seq_split.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           so, cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    dev = runtime.setup("cuda")
    card = runtime.card_line()
    gru_kernel.build()
    stamped = ctypes.CDLL(so)
    gen = torch.Generator(device=dev).manual_seed(20)
    for B, H in SHAPES:
        wh, bh, gi, h0, dhs = inputs(gen, dev, T, B, H, H)
        hs, res = gru_kernel.gru_seq_fwd(wh, bh, gi, h0)
        plan = gru_kernel.bf16_plan(B, H)
        runs = {"fwd": lambda: gru_kernel.gru_seq_fwd(wh, bh, gi, h0),
                "bwd": lambda: gru_kernel.gru_seq_bwd(wh, h0, hs, res, dhs)}
        prod = {k: runtime.cuda_ms(f, 50) for k, f in runs.items()}
        buf = (ctypes.c_ulonglong * 20)()
        saved = gru_kernel._lib, gru_kernel.build_log
        gru_kernel._lib = None
        gru_kernel.compile_library = lambda _src: (stamped, proc.stderr)
        try:
            gru_kernel.build()
            stamped_ms = {k: runtime.cuda_ms(f, 50) for k, f in runs.items()}
            for f in runs.values():
                f()
            torch.cuda.synchronize()
            code = stamped.gru_seq_mma_split(buf)
        finally:
            gru_kernel._lib, gru_kernel.build_log = saved
            gru_kernel.compile_library = cuda_build.compile_library
        if code:
            raise RuntimeError(f"copying the split: CUDA error {code}")
        # block 0 walks ceil(tiles / grid) tiles of T (backward T + 1) steps
        for k, (kind, grid) in enumerate((("fwd", plan["grid_fwd"]),
                                          ("bwd", plan["grid_bwd"]))):
            v = buf[10 * k:10 * k + 10]
            if not v[9]:
                raise RuntimeError(f"B {B} H {H}: {kind} wrote no split")
            ghz = v[7] / v[8]
            steps = -(-plan["tiles"] // grid) * (T + (kind == "bwd"))
            us = [c / ghz / 1e3 for c in v[:7]]
            print(f"{kind} split T {T} B {B} H {H} ({card}; plan {plan}; "
                  f"production {prod[kind]:.6f} ms, stamped "
                  f"{stamped_ms[kind]:.6f} ms; block 0's span "
                  f"{v[8] / 1e3:.2f} us at {ghz:.3f} GHz, {steps} steps): "
                  f"prologue {us[5] + us[6] + us[0]:.2f} us ("
                  + ", ".join(f"{PHASES[i]} {us[i]:.2f}" for i in (5, 6, 0))
                  + "); a step "
                  + ", ".join(f"{PHASES[i]} {us[i] / steps:.3f} us"
                              for i in range(1, 5))
                  + f" (sum {sum(us[1:5]) / steps:.3f} us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
