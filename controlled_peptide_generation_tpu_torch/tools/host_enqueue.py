"""Host time per call of the train step's kernel wrappers: what the host
spends to check, allocate and enqueue one launch. The train step is
host-bound (PERF.md §5), so this is what a wrapper costs a step.

    python -m controlled_peptide_generation_tpu_torch.tools.host_enqueue

For each wrapper at the train step's shapes (B5's value and gradient at
N 32, D 100, and their C entries alone; B2's backward at B 32, T 25,
H 102) it times BLOCKS blocks of CALLS calls on the host clock, with a
synchronize between blocks and outside the timing, and prints the median
and quartiles of host microseconds per call, with the card's name and
power limit. Needs CUDA.
"""

import json
import statistics
import time

import torch

from ..ops import gru as gru_ops
from ..ops import gru_kernel, mmd_kernel
from ..utils import runtime

BLOCKS = 30
CALLS = 100


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("host_enqueue measures the card: it needs CUDA")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    z1 = torch.randn((32, 100), generator=g, device=dev)
    z2 = torch.randn((32, 100), generator=g, device=dev)
    one = torch.ones((), device=dev)
    T, B, H = 25, 32, 102
    p = gru_ops.init_gru_params(g, 252, H, dev)
    gi = torch.randn((T, B, 3 * H), generator=g, device=dev)
    h0 = torch.randn((B, H), generator=g, device=dev)
    dhs = torch.randn((T, B, H), generator=g, device=dev)
    hs, res = gru_kernel.gru_seq_fwd(p["wh"], p["bh"], gi, h0)
    # B5's C entries alone, on buffers made beforehand: the launch set-up
    # without the wrapper's checks and allocations
    lib = mmd_kernel.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty((2 * lib.mmd_full_blocks(32),), dtype=torch.float64,
                       device=dev)
    out = torch.empty((), device=dev)
    gx = torch.empty_like(z1)
    count = mmd_kernel._counter(dev, stream)
    fwd_args = (z1.data_ptr(), z2.data_ptr(), part.data_ptr(),
                count.data_ptr(), out.data_ptr(), 32, 100, 49.0, 0, stream)
    bwd_args = (z1.data_ptr(), z2.data_ptr(), one.data_ptr(), gx.data_ptr(),
                32, 100, 49.0, 0, stream)
    wrappers = {
        "mmd_full_fwd N 32": lambda: mmd_kernel.mmd_full_fwd(z1, z2, 7.0),
        "mmd_full_fwd_f32 (C entry) N 32":
            lambda: lib.mmd_full_fwd_f32(*fwd_args),
        "mmd_full_bwd N 32": lambda: mmd_kernel.mmd_full_bwd(z1, z2, one,
                                                             7.0),
        "mmd_full_bwd_f32 (C entry) N 32":
            lambda: lib.mmd_full_bwd_f32(*bwd_args),
        "gru_seq_bwd B 32 H 102":
            lambda: gru_kernel.gru_seq_bwd(p["wh"], h0, hs, res, dhs),
    }
    report = {"card": runtime.card_line(), "us_per_call": {}}
    for name, fn in wrappers.items():
        for _ in range(CALLS):
            fn()
        per_call = []
        for _ in range(BLOCKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            per_call.append(1e6 * (time.perf_counter() - t0) / CALLS)
        torch.cuda.synchronize()
        q1, med, q3 = statistics.quantiles(per_call, n=4)
        report["us_per_call"][name] = {"median": med, "q1": q1, "q3": q3}
        print(f"[host] {name}: {med:.3f} us per call on the host clock "
              f"(quartiles {q1:.3f}-{q3:.3f}, {BLOCKS} blocks of {CALLS}) "
              f"({report['card']})", flush=True)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
