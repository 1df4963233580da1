"""The forward-only GRU scan of inference: a CUDA kernel and its plain
version.

``gru_fwd(wh, bh, gi_tm, h0, reverse)`` returns (hs [T, B, H], h_T [B, H])
for a pre-gated, time-major tape (gi = x @ wi + bi, [T, B, 3H]), with the
cell of the training scan. It replaces the TPU kernel of the JAX package
``ops/pallas_kernels.py:gru_sequence_pallas`` (``_gru_seq_kernel``); the
CUDA source is the entry ``gru_scan_f32`` of ``csrc/gru_seq.cu`` (kernel
``gru_scan_kernel``, with its design note), built with B2's kernels. It
keeps no residuals and writes h_T itself; with ``reverse`` it reads the
tape from its end (no flipped copy) and hs[t] is the state after
consuming steps t..T-1; the tape and hs may be strided views (a transposed
batch-major projection is read in place, and hs is written into a
batch-major buffer). The batch is tiled over blocks, so a whole corpus is
one launch per scan.

``ops/gru.gru_scan`` routes a scan here when autograd does not record it
(the heldout eval, the pipeline's encodings); a recorded scan stays on
B2's autograd Function. Dispatch: CPU tensors run ``gru_fwd_reference``
(a step loop of ``_gates``); CUDA tensors launch the kernel or raise, also
for a shape outside its scope (H <= 128) or a dtype other than float32:
the JAX kernel takes float32 only (on bf16 inputs its f32 gh makes the new
h f32, and storing that into its bf16 hs raises), so a bf16 scan runs B2.
``gru_fwd.launches`` counts the wrapper calls that launched it. Inside
``cuda_build.plain()`` gru_scan takes the plain version on any device.
"""

import torch

from . import gru_kernel
from .gru import _gates


def gru_fwd(wh, bh, gi_tm, h0, reverse=False):
    """(hs [T, B, H], h_T [B, H]) of the GRU scan over gi_tm [T, B, 3H]
    from h0 [B, H]; steps T-1..0 with ``reverse``. hs is a [T, B, H] view
    of a batch-major [B, T, H] buffer."""
    if gi_tm.device.type == "cpu":
        return gru_fwd_reference(wh, bh, gi_tm, h0, reverse)
    if gi_tm.dtype != torch.float32:
        raise NotImplementedError(
            f"the forward-only GRU scan (B4) takes float32, got "
            f"{gi_tm.dtype}: its JAX kernel (ops/pallas_kernels.py:"
            "gru_sequence_pallas) takes float32 only, storing its f32 state "
            "into a bf16 hs raises; a bf16 scan runs B2 (ops/gru.gru_scan)")
    if gi_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {gi_tm.device}")
    T, B, _ = gi_tm.shape
    H = wh.shape[0]
    dev = gru_kernel._validate({"gi_tm": (gi_tm, (T, B, 3 * H)),
                                "wh": (wh, (H, 3 * H)), "bh": (bh, (3 * H,)),
                                "h0": (h0, (B, H))}, T, B, H)
    if gi_tm.stride(2) != 1 or min(gi_tm.stride(0), gi_tm.stride(1)) < 1:
        gi_tm = gi_tm.contiguous()
    wh, bh, h0 = (a.contiguous() for a in (wh, bh, h0))
    hs = torch.empty((B, T, H), dtype=torch.float32,
                     device=dev).transpose(0, 1)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0:
        return hs, h0.clone()
    lib = gru_kernel.build()
    with torch.cuda.device(dev):
        code = lib.gru_scan_f32(
            gi_tm.data_ptr(), gi_tm.stride(0), gi_tm.stride(1),
            wh.data_ptr(), bh.data_ptr(), h0.data_ptr(), hs.data_ptr(),
            hs.stride(0), hs.stride(1), h_T.data_ptr(), T, B, H,
            int(bool(reverse)), gru_kernel._stream(dev))
    gru_kernel._check(lib, code, "gru_scan_f32 launch")
    gru_fwd.launches += 1
    return hs, h_T


gru_fwd.launches = 0


def gru_fwd_reference(wh, bh, gi_tm, h0, reverse=False):
    """Plain torch version: a step loop of ``_gates`` over the tape, from
    its end with ``reverse``; returns (hs [T, B, H], h_T)."""
    T = gi_tm.shape[0]
    hs = [None] * T
    h = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = _gates(gi_tm[t], h @ wh + bh, h)
        hs[t] = h
    return torch.stack(hs), h
