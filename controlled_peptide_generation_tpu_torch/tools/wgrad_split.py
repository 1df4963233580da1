"""Where the bf16 weight gradient's time goes on the card: a clocked split
of ``gru_wgrad_mma_kernel``'s phases.

    python -m controlled_peptide_generation_tpu_torch.tools.wgrad_split

Copies csrc/gru_seq.cu into build/wgrad_split/, puts a read of the global
timer (%globaltimer, ns) at each of the kernel's ``// [split i: name]``
markers, for the first thread of the first block (block 0 of cluster 0 of
tile 0) and, from the cluster step on, of the block of the last cluster
of the last tile, builds it with nvcc beside the production build, and
runs ``gru_seq_wgrad`` through it (the package's wrapper on the stamped
library) at T 25, B 32 and 1,024, H 80 and 102, on dgi and dghn from B2's
own bf16 backward of seeded inputs. Prints, per shape, the stamped
launch's CUDA-event time, the production kernel's time (CUDA events,
``utils/runtime.cuda_ms``), the plan, and each phase's time from the
block's start (the first slice's phases apart from the rest). Only the
stamps of the one launch read are printed: a slot the launch did not
write (a split the block never reached, or one left by an earlier launch)
is older than the block's start and is skipped. The stamps cost the one
thread that writes them a few global stores. Needs CUDA.
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

SHAPES = ((32, 80), (1024, 80), (32, 102), (1024, 102))
SLOTS = 96        # stamps per block: splits 0-9, then 10 a slice for 8 slices


def stamped_source(src):
    """gru_seq.cu with a global-timer read at each split marker of the
    weight-gradient kernel, and an entry that copies the stamps out."""
    def stamp(m):
        i, name = int(m.group(1)), m.group(2)
        idx = (f"(it < 8 ? {i} + 10 * (it + 1) : {i})"
               if name in ("slice in", "laid out") else str(i))
        return (f"  {{ unsigned long long t_; asm volatile(\"mov.u64 %0, "
                f"%%globaltimer;\" : \"=l\"(t_)); if (threadIdx.x == 0 && "
                f"blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) "
                f"g_split[{idx}] = t_; if (threadIdx.x == 0 && blockIdx.x "
                f"== 0 && blockIdx.y == gridDim.y - 1 && blockIdx.z == "
                f"gridDim.z - 1) g_split[{SLOTS} + {idx}] = t_; }}")
    out, n = re.subn(r"  // \[split (\d+): ([a-z ]+)\]", stamp, src)
    if n < 10:
        raise RuntimeError(f"found {n} split markers in csrc/gru_seq.cu")
    decl = f"__device__ unsigned long long g_split[{2 * SLOTS}];\n"
    out = out.replace("namespace {\n", "namespace {\n" + decl, 1)
    return out + ("\nextern \"C\" int gru_seq_wgrad_split(unsigned long "
                  "long* h) { return (int)cudaMemcpyFromSymbol(h, g_split, "
                  "sizeof(g_split)); }\nextern \"C\" int "
                  "gru_seq_wgrad_split_clear() { unsigned long long z[sizeof("
                  "g_split) / 8] = {}; return (int)cudaMemcpyToSymbol("
                  "g_split, z, sizeof(g_split)); }\n")


def check(code, what):
    """Raise on a failed copy of the stamps (a CUDA error code)."""
    if code:
        raise RuntimeError(f"copying the split stamps ({what}): CUDA error "
                           f"{code}")


def main(argv=None):
    if not torch.cuda.is_available():
        print("wgrad_split: CUDA is not available", file=sys.stderr)
        return 2
    from ..ops import cuda_build, gru_kernel
    from ..utils import runtime
    from .grad_kernels import wgrad_inputs
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(here)
    out_dir = os.path.join(root, "build", "wgrad_split")
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
    prod = gru_kernel.build()
    stamped = ctypes.CDLL(so)
    gen = torch.Generator(device=dev).manual_seed(19)
    names = ("start", "slice in", "laid out", "products done",
             "partial written", "cluster in step", "ranks summed",
             "cluster done", "counted in", "clusters summed")
    for B, H in SHAPES:
        h0, hs, dgi, dghn = wgrad_inputs(gen, dev, 25, B, H)
        plan = gru_kernel.wgrad_plan(25, B, H, bf16=True)

        def run():
            return gru_kernel.gru_seq_wgrad(h0, hs, dgi, dghn)
        prod_ms = runtime.cuda_ms(run, 50)
        buf = (ctypes.c_ulonglong * (2 * SLOTS))()
        # the package's wrapper on the stamped library, restored after
        saved = gru_kernel._lib, gru_kernel.build_log
        gru_kernel._lib = None
        gru_kernel.compile_library = lambda _src: (stamped, proc.stderr)
        try:
            gru_kernel.build()
            stamped_ms = runtime.cuda_ms(run, 50)
            torch.cuda.synchronize()
            check(stamped.gru_seq_wgrad_split_clear(), "clear")
            run()
            torch.cuda.synchronize()
            check(stamped.gru_seq_wgrad_split(buf), "read")
        finally:
            gru_kernel._lib, gru_kernel.build_log = saved
            gru_kernel.compile_library = cuda_build.compile_library
        for who, base in (("first block", 0), ("last cluster's block",
                                               SLOTS)):
            t0 = buf[base]
            if not t0:
                raise RuntimeError(f"B {B} H {H}: the {who} wrote no start")

            def us(i):
                """slot i's time from t0, None where this launch did not
                write it"""
                return (buf[base + i] - t0) / 1e3 if buf[base + i] >= t0 \
                    else None
            rel = {names[i]: us(i) for i in range(10) if us(i) is not None}
            slices = [(us(10 * (q + 1) + 1), us(10 * (q + 1) + 2))
                      for q in range(8)]
            slices = [(a, b) for a, b in slices if a is not None]
            print(f"wgrad split T 25 B {B} H {H} ({card}; plan {plan}; "
                  f"production {prod_ms:.6f} ms, stamped {stamped_ms:.6f} "
                  f"ms), {who}, us from its start: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in rel.items())
                  + "; first slices (in, laid out): "
                  + ", ".join(f"({a:.2f}, {'-' if b is None else f'{b:.2f}'})"
                              for a, b in slices),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
