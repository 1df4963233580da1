"""GRU cell in the torch/cuDNN convention.

Two bias vectors, gate order r, z, n along the 3H axis, and the reset gate
applied to the projected hidden state with ``bh_n`` inside it:
``n = tanh(gi_n + r * (h @ wh_n + bh_n))``. Weights are stored for
``x @ W``: ``wi [in, 3H]``, ``wh [H, 3H]``.

``gru_scan`` runs a whole sequence: the input projection of every step is
one product hoisted out of the recurrence, and the recurrence itself is
``gru_kernel.gru_seq`` when autograd records it (B2) and
``gru_fwd_kernel.gru_fwd`` otherwise (B4): the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors or inside
``cuda_build.plain()``. A hidden width beyond the kernels' scope (H >
``gru_kernel.MAX_H``, the deconv decoder's ``useRNN`` GRU at H = emb_dim)
takes the plain recurrence on any device, decided before any launch, as
the JAX package sends such widths to its XLA arm (its kernels'
``applicable``); ``gru_scan.plain_runs`` counts those scans.

A bf16 scan (bf16 weights and state) runs B2's bf16 entries, with
autograd and without, as the JAX ``gru_scan`` sends a bf16 scan to its
``pallas_gru.gru_seq``: B4 takes float32 only, as its TPU kernel does. On
CUDA tensors a bf16 scan launches B2 or raises (H > 127 included); it
never runs a plain version there outside ``cuda_build.plain()``.
"""

import torch

from .nn import uniform


def init_gru_params(gen, in_dim, h_dim, device="cpu"):
    bound = 1.0 / h_dim ** 0.5
    return {
        "wi": uniform(gen, (in_dim, 3 * h_dim), bound, device),
        "wh": uniform(gen, (h_dim, 3 * h_dim), bound, device),
        "bi": uniform(gen, (3 * h_dim,), bound, device),
        "bh": uniform(gen, (3 * h_dim,), bound, device),
    }


def _gates(gi, gh, h):
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell_pregated(params, gi, h):
    """One step with the input projection already applied (gi = x@wi+bi)."""
    gh = h @ params["wh"] + params["bh"]
    return _gates(gi, gh, h)


def gru_scan(params, xs, h0, reverse=False):
    """Full-sequence GRU: xs [B, T, in], h0 [B, H] -> (hs [B, T, H],
    h_last [B, H]). With reverse=True the scan runs T-1..0 and hs[:, t]
    is the state after consuming xs[:, t..T-1] (torch bidirectional
    semantics); h_last is then the state after xs[:, 0].

    A scan that autograd records (grad enabled and an input requiring
    grad), and every bf16 scan, runs B2's differentiable recurrence; any
    other scan runs the forward-only kernel B4, which reads the tape in
    place; beyond the kernels' H scope a float32 scan runs its plain
    version."""
    from . import cuda_build, gru_fwd_kernel, gru_kernel
    gi_tm = (xs @ params["wi"] + params["bi"]).transpose(0, 1)  # [T, B, 3H]
    wh, bh = params["wh"], params["bh"]
    bf16 = wh.dtype == torch.bfloat16
    outside = not bf16 and wh.shape[0] > gru_kernel.MAX_H
    gru_scan.plain_runs += outside
    if not bf16 and not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (gi_tm, wh, bh, h0))):
        fwd = (gru_fwd_kernel.gru_fwd_reference
               if outside or cuda_build.in_plain()
               else gru_fwd_kernel.gru_fwd)
        hs_tm, h_last = fwd(wh, bh, gi_tm, h0, reverse)
        return hs_tm.transpose(0, 1), h_last
    if reverse:
        gi_tm = gi_tm.flip(0)
    seq = gru_kernel.gru_seq_reference if outside else gru_kernel.gru_seq
    hs_tm = seq(wh, bh, gi_tm.contiguous(), h0)
    h_last = hs_tm[-1]
    if reverse:
        hs_tm = hs_tm.flip(0)
    return hs_tm.transpose(0, 1), h_last


gru_scan.plain_runs = 0
