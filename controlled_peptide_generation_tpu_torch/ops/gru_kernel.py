"""The whole-sequence GRU recurrence of training: CUDA kernels, their
autograd Function and their plain versions.

``gru_seq(wh, bh, gi_tm, h0)`` runs h_t = GRU(gi_t, h_{t-1}) over a
pre-gated, time-major tape (gi = x @ wi + bi, [T, B, 3H]) and returns
hs [T, B, H]; its backward is the reverse-time gradient recurrence. It
replaces the TPU kernels of the JAX package (``ops/pallas_gru.py:gru_seq``,
forward ``_fwd_kernel`` and backward ``_bwd_kernel``). The CUDA source,
with its design note, is ``csrc/gru_seq.cu``: the forward scan (the
recurrent weights held in registers for the whole scan), the backward
recurrence (dgi, dh0 and the n-section of the recurrent gradient) and the
recurrent-weight gradient (one launch: each output tile's rows split over
a thread-block cluster, whose partials are summed in a fixed order, so
two runs give the same bits).

Dispatch: CPU tensors run the plain versions (``gru_seq_reference``, a
step loop of ``_gates``, and ``gru_seq_bwd_reference``, the explicit
reverse recurrence); CUDA tensors launch the kernels or raise, also for a
shape outside the kernels' scope (H <= 128) or a dtype other than float32.
``gru_seq_fwd.launches``, ``gru_seq_bwd.launches`` and
``gru_seq_wgrad.launches`` count the wrapper calls that launched kernels.
Inside ``cuda_build.plain()`` ``gru_seq`` runs the step loop under
autograd on any device: the kernels' yardstick on CUDA, and with it the
route of every ``gru_scan`` above it (encoder, decoder, train step).
"""

import ctypes
import re
import threading

import torch

from .cuda_build import compile_library, in_plain
from .gru import _gates

MAX_H = 128           # the kernels' scope: wh [H, 3H] on one SM

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def build():
    """Compile csrc/gru_seq.cu (once per source content) and load it.
    Returns the ctypes library; the nvcc output is kept in `build_log`."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_library("gru_seq.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gru_seq_fwd_f32.argtypes = [p] * 5 + [i] * 3 + [p]
        lib.gru_seq_bwd_f32.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.gru_seq_wgrad_f32.argtypes = [p] * 6 + [i] * 3 + [p]
        q = ctypes.c_longlong
        # B4's entry (ops/gru_fwd_kernel.py): strides are 64-bit
        lib.gru_scan_f32.argtypes = [p, q, q, p, p, p, p, q, q, p] + [i] * 4 \
            + [p]
        for fn in (lib.gru_seq_fwd_f32, lib.gru_seq_bwd_f32,
                   lib.gru_seq_wgrad_f32, lib.gru_scan_f32):
            fn.restype = i
        lib.gru_seq_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.gru_seq_plan.restype = i
        lib.gru_seq_wgrad_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.gru_seq_wgrad_plan.restype = i
        lib.gru_seq_error_string.argtypes = [i]
        lib.gru_seq_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        msg = lib.gru_seq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_plan(B, H):
    """The recurrence kernels' plans at these shapes: the scan's lanes per
    hidden unit S, k values per lane KS, rows per block R, threads per
    block and row tiles; the backward's rows per block, threads per block
    and dynamic shared bytes."""
    lib = build()
    out = (ctypes.c_int * 8)()
    _check(lib, lib.gru_seq_plan(B, H, out), "gru_seq_plan")
    return {"scan": dict(zip(("S", "KS", "rows", "threads", "tiles"),
                             out[:5])),
            "bwd": dict(zip(("rows", "threads", "smem"), out[5:]))}


def wgrad_plan(T, B, H):
    """The weight gradient's plan: output tile (k, m), number of tiles,
    cluster size (blocks per tile) and T*B rows per block."""
    lib = build()
    out = (ctypes.c_int * 5)()
    _check(lib, lib.gru_seq_wgrad_plan(T, B, H, out), "gru_seq_wgrad_plan")
    return dict(zip(("tile_k", "tile_m", "tiles", "cluster", "rows"), out))


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SCAN = re.compile(r"gru_scan_kernelILi(\d+)ELi(\d+)ELi(\d+)E")
_WGRAD = re.compile(r"gru_wgrad_kernelILi(\d+)E")


def ptxas_report(log=None):
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    scan and weight-gradient instantiations, read from ptxas' -v output in
    the build log (``build_log`` by default). Scan kernels are named
    ``gru_scan_kernel<KS, S, R>`` (k values per lane, lanes per unit, rows
    per block), weight-gradient kernels ``gru_wgrad_kernel<V>`` (floats per
    copy)."""
    report, name = {}, None
    for line in (build_log if log is None else log).splitlines():
        m = _ENTRY.search(line)
        if m:
            scan, wgrad = _SCAN.search(m.group(1)), _WGRAD.search(m.group(1))
            name = (f"gru_scan_kernel<{', '.join(scan.groups())}>" if scan
                    else f"gru_wgrad_kernel<{wgrad.group(1)}>" if wgrad
                    else None)
            if name:
                report[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = _SPILL.search(line)
        if m:
            report[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = _REGS.search(line)
        if m:
            report[name][0] = int(m.group(1))
            name = None
    return {k: tuple(v) for k, v in report.items()}


def _validate(named, T, B, H):
    """Raise unless every tensor is float32, on one CUDA device, of its
    expected shape, and the shapes are in the kernels' scope."""
    dev = next(iter(named.values()))[0].device
    if not 1 <= H <= MAX_H or T < 1:
        raise ValueError(f"shape outside the GRU kernels' scope: T={T} "
                         f"H={H} (need T >= 1, 1 <= H <= {MAX_H})")
    for name, (a, shape) in named.items():
        if a.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA GRU kernels take float32, got {a.dtype} for "
                f"{name} (bf16 is queued in ROADMAP.md)")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, expected {dev}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
    return dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gru_seq_fwd(wh, bh, gi_tm, h0):
    """hs [T, B, H] = the GRU scan over gi_tm [T, B, 3H] from h0 [B, H]."""
    if gi_tm.device.type == "cpu":
        return gru_seq_reference(wh, bh, gi_tm, h0)
    if gi_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {gi_tm.device}")
    T, B, _ = gi_tm.shape
    H = wh.shape[0]
    dev = _validate({"gi_tm": (gi_tm, (T, B, 3 * H)),
                     "wh": (wh, (H, 3 * H)), "bh": (bh, (3 * H,)),
                     "h0": (h0, (B, H))}, T, B, H)
    gi_tm, wh, bh, h0 = (a.contiguous() for a in (gi_tm, wh, bh, h0))
    hs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    if B == 0:
        return hs
    lib = build()
    with torch.cuda.device(dev):
        code = lib.gru_seq_fwd_f32(gi_tm.data_ptr(), wh.data_ptr(),
                                   bh.data_ptr(), h0.data_ptr(),
                                   hs.data_ptr(), T, B, H, _stream(dev))
    _check(lib, code, "gru_seq_fwd_f32 launch")
    gru_seq_fwd.launches += 1
    return hs


def gru_seq_bwd(wh, bh, gi_tm, h0, hs, dhs):
    """The reverse recurrence: (dgi [T, B, 3H], dghn [T, B, H], dh0 [B, H])
    where dghn is the n-section of the recurrent pre-activation gradient
    (dn_pre * r); the r and z sections equal dgi's."""
    if gi_tm.device.type == "cpu":
        return _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs, dhs)
    if gi_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {gi_tm.device}")
    T, B, _ = gi_tm.shape
    H = wh.shape[0]
    dev = _validate({"gi_tm": (gi_tm, (T, B, 3 * H)),
                     "wh": (wh, (H, 3 * H)), "bh": (bh, (3 * H,)),
                     "h0": (h0, (B, H)), "hs": (hs, (T, B, H)),
                     "dhs": (dhs, (T, B, H))}, T, B, H)
    ins = tuple(a.contiguous() for a in (gi_tm, wh, bh, h0, hs, dhs))
    dgi = torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
    dghn = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0:
        return dgi, dghn, dh0
    lib = build()
    with torch.cuda.device(dev):
        code = lib.gru_seq_bwd_f32(*(a.data_ptr() for a in ins),
                                   dgi.data_ptr(), dghn.data_ptr(),
                                   dh0.data_ptr(), T, B, H, _stream(dev))
    _check(lib, code, "gru_seq_bwd_f32 launch")
    gru_seq_bwd.launches += 1
    return dgi, dghn, dh0


def gru_seq_wgrad(h0, hs, dgi, dghn):
    """(dwh [H, 3H], dbh [3H]): sums over T*B of h_{t-1}^T dgh and of dgh,
    dgh = [dgi_r, dgi_z, dghn]."""
    if hs.device.type == "cpu":
        return _wgrad_reference(h0, hs, dgi, dghn)
    if hs.device.type != "cuda":
        raise ValueError(f"unsupported device {hs.device}")
    T, B, H = hs.shape
    dev = _validate({"h0": (h0, (B, H)), "hs": (hs, (T, B, H)),
                     "dgi": (dgi, (T, B, 3 * H)),
                     "dghn": (dghn, (T, B, H))}, T, B, H)
    ins = tuple(a.contiguous() for a in (h0, hs, dgi, dghn))
    if B == 0:
        return (torch.zeros((H, 3 * H), dtype=torch.float32, device=dev),
                torch.zeros((3 * H,), dtype=torch.float32, device=dev))
    # the kernel writes every entry
    dwh = torch.empty((H, 3 * H), dtype=torch.float32, device=dev)
    dbh = torch.empty((3 * H,), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        code = lib.gru_seq_wgrad_f32(*(a.data_ptr() for a in ins),
                                     dwh.data_ptr(), dbh.data_ptr(), T, B,
                                     H, _stream(dev))
    _check(lib, code, "gru_seq_wgrad_f32 launch")
    gru_seq_wgrad.launches += 1
    return dwh, dbh


gru_seq_fwd.launches = 0
gru_seq_bwd.launches = 0
gru_seq_wgrad.launches = 0


def reset_launches():
    for fn in (gru_seq_fwd, gru_seq_bwd, gru_seq_wgrad):
        fn.launches = 0


class GruSeq(torch.autograd.Function):
    """hs = gru_seq(wh, bh, gi_tm, h0), differentiable in all four."""

    @staticmethod
    def forward(ctx, wh, bh, gi_tm, h0):
        hs = gru_seq_fwd(wh, bh, gi_tm, h0)
        ctx.save_for_backward(wh, bh, gi_tm, h0, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        wh, bh, gi_tm, h0, hs = ctx.saved_tensors
        dgi, dghn, dh0 = gru_seq_bwd(wh, bh, gi_tm, h0, hs, dhs)
        dwh, dbh = gru_seq_wgrad(h0, hs, dgi, dghn)
        return dwh, dbh, dgi, dh0


def gru_seq(wh, bh, gi_tm, h0):
    """Fused GRU over a whole sequence: wh [H, 3H], bh [3H], gi_tm
    [T, B, 3H] time-major with bi folded in, h0 [B, H] -> hs [T, B, H]."""
    if in_plain():
        return gru_seq_reference(wh, bh, gi_tm, h0)
    return GruSeq.apply(wh, bh, gi_tm, h0)


# ---- plain versions ---------------------------------------------------------

def gru_seq_reference(wh, bh, gi_tm, h0):
    """Plain torch version of the forward: a step loop of ``_gates``
    (differentiable by autograd)."""
    h = h0
    hs = []
    for t in range(gi_tm.shape[0]):
        h = _gates(gi_tm[t], h @ wh + bh, h)
        hs.append(h)
    return torch.stack(hs)


def _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs, dhs):
    H = wh.shape[0]
    hprev = torch.cat([h0[None], hs[:-1]])
    dgi = torch.empty_like(gi_tm)
    dghn = torch.empty_like(hs)
    dh = torch.zeros_like(h0)
    for t in range(gi_tm.shape[0] - 1, -1, -1):
        dh = dh + dhs[t]
        hp = hprev[t]
        gh = hp @ wh + bh
        gh_n = gh[:, 2 * H:]
        gi = gi_tm[t]
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh_n)
        dz = dh * (hp - n)
        dn_pre = dh * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * gh_n * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dgi[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
        dghn[t] = dn_pre * r
        dgh = torch.cat([dr_pre, dz_pre, dghn[t]], dim=1)
        dh = dh * z + dgh @ wh.T
    return dgi, dghn, dh


def _wgrad_reference(h0, hs, dgi, dghn):
    H = hs.shape[2]
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(-1, H)
    dgh = torch.cat([dgi[..., :2 * H], dghn], dim=2).reshape(-1, 3 * H)
    return hprev.T @ dgh, dgh.sum(0)


def gru_seq_bwd_reference(wh, bh, gi_tm, h0, hs, dhs):
    """Plain torch version of the whole backward, the explicit reverse
    recurrence of the JAX kernel's ``_bwd_kernel``: returns (dwh, dbh,
    dgi, dh0) for the incoming dhs [T, B, H]."""
    dgi, dghn, dh0 = _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs, dhs)
    dwh, dbh = _wgrad_reference(h0, hs, dgi, dghn)
    return dwh, dbh, dgi, dh0
