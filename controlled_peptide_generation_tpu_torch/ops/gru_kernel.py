"""The whole-sequence GRU recurrence of training: CUDA kernels, their
autograd Function and their plain versions.

``gru_seq(wh, bh, gi_tm, h0)`` runs h_t = GRU(gi_t, h_{t-1}) over a
pre-gated, time-major tape (gi = x @ wi + bi, [T, B, 3H]) and returns
hs [T, B, H]; its backward is the reverse-time gradient recurrence. It
replaces the TPU kernels of the JAX package (``ops/pallas_gru.py:gru_seq``,
forward ``_fwd_kernel`` and backward ``_bwd_kernel``). The CUDA source,
with its design note, is ``csrc/gru_seq.cu``: the forward scan (the
recurrent weights held in registers for the whole scan; in training it
also stores each step's gates r, z, n and gh_n to a residual tape
[T, B, H, 4]), the backward recurrence (from those residuals, with wh held
in registers too: dgi, dh0 and the n-section of the recurrent gradient)
and the recurrent-weight gradient (one launch: each output tile's rows
split over a thread-block cluster, whose partials are summed in a fixed
order, so two runs give the same bits; in bf16 on the tensor cores, its
rows staged by bulk copies, its clusters' sums meeting in a scratch
workspace of one scratch and one set of counters per stream,
``_wgrad_workspace``).

bf16 (the JAX kernel's dt, ``pallas_gru.applicable``): the same three
kernels store gi, wh and bh, h0, hs, dhs, dgi, dghn and dh0 in bf16 and
compute in f32, rounding where the JAX kernels round when XLA evaluates
them (``_gates_bf16``, ``_bwd_step_bf16``): forward, gh = h @ wh + bh
accumulated in f32 and rounded once, then r, z, n and the blend's ops;
backward, dhs rounded once, the gates as the JAX backward recomputes them
(r, z and n in f32, unrounded, n's argument with the rounded r), the four
gate gradients rounded before their stores and products, dh carried in
f32 and rounded once into dh0; dwh and dbh summed in f32 and rounded once.
The residual tape stays f32 and holds what the JAX backward recomputes:
the unrounded f32 r, z and n and the rounded gh_n. The scope in bf16 is
the JAX kernel's, H <= 127 (``MAX_H_BF16``; one lane of its 128 is the
bias lane).

Dispatch: CPU tensors run the plain versions (``gru_seq_res_reference``,
the step loop that returns hs and the residual tape, and
``gru_seq_reference``, its hs; ``_bwd_chain_reference``, the backward
recurrence from the residuals, the function of the CUDA backward; and
``gru_seq_bwd_reference``, the explicit reverse recurrence that
recomputes the gates, which ``GruSeq`` runs on CPU tensors); CUDA tensors
launch the kernels or raise, also for a shape outside the kernels' scope
(H <= 128, H <= 127 in bf16) or a dtype other than float32 and bfloat16.
``gru_seq_fwd.launches``, ``gru_seq_bwd.launches`` and
``gru_seq_wgrad.launches`` count the wrapper calls that launched the f32
kernels, the ``launches_bf16`` attributes those that launched the bf16
ones. A ``gru_seq`` that autograd does not record launches the forward
alone, with no residual tape (``gru_seq_fwd(..., residuals=False)``), as
the JAX forward writes hs alone. Inside ``cuda_build.plain()``
``gru_seq`` runs the plain versions on any device: the kernels' yardstick
on CUDA, and with it the route of every
``gru_scan`` above it (encoder, decoder, train step); in f32 the step loop
under autograd, in bf16 ``GruSeq`` on the plain versions (autograd's own
bf16 backward would round elsewhere).
"""

import ctypes
import re
import threading

import torch

from .cuda_build import compile_library, in_plain, ptxas_usage

MAX_H = 128           # the kernels' scope: wh [H, 3H] on one SM
MAX_H_BF16 = 127      # in bf16 the JAX kernel's (``pallas_gru.applicable``)
DTYPES = (torch.float32, torch.bfloat16)

_lib = None
_lib_lock = threading.Lock()
build_log = ""
# (device index, stream handle) -> the bf16 weight gradient's workspace
_workspaces = {}


def build():
    """Compile csrc/gru_seq.cu (once per source content) and load it.
    Returns the ctypes library; the nvcc output is kept in `build_log`."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_library("gru_seq.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        entries = []
        for t in ("f32", "bf16"):
            fwd, bwd, wgrad = (getattr(lib, f"gru_seq_{n}_{t}")
                               for n in ("fwd", "bwd", "wgrad"))
            fwd.argtypes = [p] * 6 + [i] * 3 + [p]
            bwd.argtypes = [p] * 8 + [i] * 3 + [p]
            wgrad.argtypes = [p] * (6 if t == "f32" else 8) + [i] * 3 + [p]
            entries += [fwd, bwd, wgrad]
        q = ctypes.c_longlong
        # B4's entry (ops/gru_fwd_kernel.py): strides are 64-bit
        lib.gru_scan_f32.argtypes = [p, q, q, p, p, p, p, q, q, p] + [i] * 4 \
            + [p]
        for fn in entries + [lib.gru_scan_f32]:
            fn.restype = i
        lib.gru_seq_plan.argtypes = [i, i, ctypes.POINTER(i)]
        lib.gru_seq_plan.restype = i
        lib.gru_seq_wgrad_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.gru_seq_wgrad_plan.restype = i
        lib.gru_seq_wgrad_workspace.argtypes = [ctypes.POINTER(i)]
        lib.gru_seq_wgrad_workspace.restype = None
        lib.gru_seq_error_string.argtypes = [i]
        lib.gru_seq_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        msg = lib.gru_seq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_plan(B, H):
    """The recurrence kernels' plan at these shapes, shared by the scan and
    the backward (the same table by H, the same row tiles): lanes per
    hidden unit S, values per lane KS, rows per block R, threads per
    block, row tiles, and the grid (resident blocks at most) of each
    kernel: the forward-only scan, the training forward (with its residual
    stores) and the backward."""
    lib = build()
    out = (ctypes.c_int * 8)()
    _check(lib, lib.gru_seq_plan(B, H, out), "gru_seq_plan")
    plan = dict(zip(("S", "KS", "rows", "threads", "tiles"), out[:5]))
    return {"scan": dict(plan, grid=out[5]),
            "train_fwd": dict(plan, grid=out[6]),
            "bwd": dict(plan, grid=out[7])}


def wgrad_plan(T, B, H, bf16=False):
    """The weight gradient's plan: output tile (k, m), number of tiles,
    cluster size, T*B rows per block and clusters per tile; with ``bf16``
    the bf16 entry's (on the tensor cores: one tile over all of k, the
    rows of a tile over ``groups`` clusters, whose sums meet in scratch)."""
    lib = build()
    out = (ctypes.c_int * 6)()
    _check(lib, lib.gru_seq_wgrad_plan(T, B, H, int(bf16), out),
           "gru_seq_wgrad_plan")
    return dict(zip(("tile_k", "tile_m", "tiles", "cluster", "rows",
                     "groups"), out))


def _wgrad_workspace(lib, dev, stream):
    """(scratch, counters) of the bf16 weight gradient's launches on
    ``stream`` of device ``dev``, one pair per device and stream, sized for
    any shape in scope: the clusters of a tile meet in the f32 scratch,
    which each launch writes before it reads; the counters are zeroed once
    here and left zero by every launch (no memset a call)."""
    key = (dev.index, stream)
    ws = _workspaces.get(key)
    if ws is not None:
        return ws
    with _lib_lock:
        if key not in _workspaces:
            sizes = (ctypes.c_int * 2)()
            lib.gru_seq_wgrad_workspace(sizes)
            _workspaces[key] = (
                torch.empty((sizes[1],), dtype=torch.float32, device=dev),
                torch.zeros((sizes[0],), dtype=torch.int32, device=dev))
        return _workspaces[key]


_BF16 = "(13__nv_bfloat16)?"
_SCAN = re.compile(
    r"gru_scan_kernelILi(\d+)ELi(\d+)ELi(\d+)E(?:Lb([01])E)?" + _BF16)
_BWD = re.compile(r"gru_bwd_kernelILi(\d+)ELi(\d+)ELi(\d+)E" + _BF16)
_WGRAD = re.compile(r"gru_wgrad_kernelILi(\d+)E" + _BF16)
_WGRAD_MMA = re.compile(r"gru_wgrad_mma_kernelILb([01])ELi(\d+)E")


def _kernel_name(entry):
    scan, bwd, wgrad = (_SCAN.search(entry), _BWD.search(entry),
                        _WGRAD.search(entry))
    if scan:
        ks, s, r, res, bf = scan.groups()
        return (f"gru_scan_kernel<{ks}, {s}, {r}"
                + (", residuals" if res == "1" else "")
                + (", bf16>" if bf else ">"))
    if bwd:
        ks, s, r, bf = bwd.groups()
        return f"gru_bwd_kernel<{ks}, {s}, {r}" + (", bf16>" if bf else ">")
    if wgrad:
        v, bf = wgrad.groups()
        return f"gru_wgrad_kernel<{v}" + (", bf16>" if bf else ">")
    mma = _WGRAD_MMA.search(entry)
    if mma:
        return ("gru_wgrad_mma_kernel<"
                + ("bulk" if mma.group(1) == "1" else "plain")
                + f", {mma.group(2)}, bf16>")
    return None


def ptxas_report(log=None):
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    scan, backward and weight-gradient instantiations, read from ptxas' -v
    output in the build log (``build_log`` by default). Scan kernels are
    named ``gru_scan_kernel<KS, S, R>`` (k values per lane, lanes per unit,
    rows per block; ``gru_scan_kernel<KS, S, R, residuals>`` the training
    forward's), backward kernels ``gru_bwd_kernel<KS, S, R>`` (m values per
    lane, lanes per unit, rows per block), weight-gradient kernels
    ``gru_wgrad_kernel<V>`` (values per copy) and the bf16 one on the
    tensor cores ``gru_wgrad_mma_kernel<bulk | plain, TN, bf16>`` (its
    rows staged by bulk copies, or by plain loads at an odd H; tiles TN
    columns wide); a bf16 instantiation ends in ``, bf16>``."""
    return ptxas_usage(build_log if log is None else log, _kernel_name)


def _validate(named, T, B, H, f32=()):
    """Raise unless every tensor is of its expected shape, on one CUDA
    device, and of the first tensor's dtype, float32 or bf16 (the names in
    ``f32`` are float32 in either: the residual tape), and the shapes are
    in the kernels' scope for that dtype. Returns the device."""
    first = next(iter(named.values()))[0]
    dev, dt = first.device, first.dtype
    if dt not in DTYPES:
        raise NotImplementedError(
            f"the CUDA GRU kernels take float32 or bfloat16, got {dt}")
    max_h = MAX_H if dt == torch.float32 else MAX_H_BF16
    if not 1 <= H <= max_h or T < 1:
        raise ValueError(f"shape outside the GRU kernels' scope: T={T} "
                         f"H={H} (need T >= 1, 1 <= H <= {max_h} in {dt})")
    for name, (a, shape) in named.items():
        want = torch.float32 if name in f32 else dt
        if a.dtype != want:
            raise ValueError(f"{name} is {a.dtype}, expected {want}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, expected {dev}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shape}")
    return dev


def _entry(lib, name, dt):
    """The C entry ``name``_f32 or ``name``_bf16 and the counter attribute
    of its launches."""
    if dt == torch.bfloat16:
        return getattr(lib, f"{name}_bf16"), "launches_bf16"
    return getattr(lib, f"{name}_f32"), "launches"


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gru_seq_fwd(wh, bh, gi_tm, h0, residuals=True):
    """The training forward: (hs [T, B, H], res [T, B, H, 4]), hs the GRU
    scan over gi_tm [T, B, 3H] from h0 [B, H] and res each step's gates r,
    z, n and gh_n = h_{t-1} @ wh_n + bh_n of each unit, what
    ``gru_seq_bwd`` reads. hs has the inputs' dtype (float32 or bf16), res
    is float32 (in bf16 the unrounded gates and the rounded gh_n). With
    ``residuals=False`` the kernel stores no tape and res is None: the
    forward of a scan that autograd does not record."""
    if gi_tm.device.type == "cpu":
        hs, res = gru_seq_res_reference(wh, bh, gi_tm, h0)
        return hs, res if residuals else None
    if gi_tm.device.type != "cuda":
        raise ValueError(f"unsupported device {gi_tm.device}")
    T, B, _ = gi_tm.shape
    H = wh.shape[0]
    dev = _validate({"gi_tm": (gi_tm, (T, B, 3 * H)),
                     "wh": (wh, (H, 3 * H)), "bh": (bh, (3 * H,)),
                     "h0": (h0, (B, H))}, T, B, H)
    gi_tm, wh, bh, h0 = (a.contiguous() for a in (gi_tm, wh, bh, h0))
    hs = torch.empty((T, B, H), dtype=wh.dtype, device=dev)
    res = (torch.empty((T, B, H, 4), dtype=torch.float32, device=dev)
           if residuals else None)
    if B > 0:
        lib = build()
        fn, counter = _entry(lib, "gru_seq_fwd", wh.dtype)
        with torch.cuda.device(dev):
            code = fn(gi_tm.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                      h0.data_ptr(), hs.data_ptr(),
                      res.data_ptr() if residuals else None, T, B, H,
                      _stream(dev))
        _check(lib, code, "gru_seq_fwd launch")
        setattr(gru_seq_fwd, counter, getattr(gru_seq_fwd, counter) + 1)
    return hs, res


def gru_seq_bwd(wh, h0, hs, res, dhs):
    """The reverse recurrence from the forward's residual tape res
    [T, B, H, 4] (``gru_seq_fwd``): (dgi [T, B, 3H],
    dghn [T, B, H], dh0 [B, H]) for the incoming dhs [T, B, H], where dghn
    is the n-section of the recurrent pre-activation gradient
    (dn_pre * r); the r and z sections equal dgi's. In bf16 (wh, h0, hs
    and dhs bf16, res float32) the three outputs are bf16."""
    if hs.device.type == "cpu":
        return _bwd_chain_reference(wh, h0, hs, res, dhs)
    if hs.device.type != "cuda":
        raise ValueError(f"unsupported device {hs.device}")
    T, B, H = hs.shape
    dev = _validate({"wh": (wh, (H, 3 * H)), "h0": (h0, (B, H)),
                     "hs": (hs, (T, B, H)), "res": (res, (T, B, H, 4)),
                     "dhs": (dhs, (T, B, H))}, T, B, H, f32=("res",))
    ins = tuple(a.contiguous() for a in (wh, h0, hs, res, dhs))
    dt = wh.dtype
    dgi = torch.empty((T, B, 3 * H), dtype=dt, device=dev)
    dghn = torch.empty((T, B, H), dtype=dt, device=dev)
    dh0 = torch.empty((B, H), dtype=dt, device=dev)
    if B == 0:
        return dgi, dghn, dh0
    lib = build()
    fn, counter = _entry(lib, "gru_seq_bwd", dt)
    with torch.cuda.device(dev):
        code = fn(*(a.data_ptr() for a in ins), dgi.data_ptr(),
                  dghn.data_ptr(), dh0.data_ptr(), T, B, H, _stream(dev))
    _check(lib, code, "gru_seq_bwd launch")
    setattr(gru_seq_bwd, counter, getattr(gru_seq_bwd, counter) + 1)
    return dgi, dghn, dh0


def gru_seq_wgrad(h0, hs, dgi, dghn):
    """(dwh [H, 3H], dbh [3H]): sums over T*B of h_{t-1}^T dgh and of dgh,
    dgh = [dgi_r, dgi_z, dghn], in the inputs' dtype (in bf16 summed in
    f32 and rounded once)."""
    if hs.device.type == "cpu":
        return _wgrad_reference(h0, hs, dgi, dghn)
    if hs.device.type != "cuda":
        raise ValueError(f"unsupported device {hs.device}")
    T, B, H = hs.shape
    dev = _validate({"h0": (h0, (B, H)), "hs": (hs, (T, B, H)),
                     "dgi": (dgi, (T, B, 3 * H)),
                     "dghn": (dghn, (T, B, H))}, T, B, H)
    ins = tuple(a.contiguous() for a in (h0, hs, dgi, dghn))
    dt = hs.dtype
    if B == 0:
        return (torch.zeros((H, 3 * H), dtype=dt, device=dev),
                torch.zeros((3 * H,), dtype=dt, device=dev))
    # the kernel writes every entry
    dwh = torch.empty((H, 3 * H), dtype=dt, device=dev)
    dbh = torch.empty((3 * H,), dtype=dt, device=dev)
    lib = build()
    fn, counter = _entry(lib, "gru_seq_wgrad", dt)
    with torch.cuda.device(dev):
        if dt == torch.bfloat16:
            scratch, counts = _wgrad_workspace(lib, dev, _stream(dev))
            code = fn(*(a.data_ptr() for a in ins), dwh.data_ptr(),
                      dbh.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
                      T, B, H, _stream(dev))
        else:
            code = fn(*(a.data_ptr() for a in ins), dwh.data_ptr(),
                      dbh.data_ptr(), T, B, H, _stream(dev))
    _check(lib, code, "gru_seq_wgrad launch")
    setattr(gru_seq_wgrad, counter, getattr(gru_seq_wgrad, counter) + 1)
    return dwh, dbh


def reset_launches():
    for fn in (gru_seq_fwd, gru_seq_bwd, gru_seq_wgrad):
        fn.launches = fn.launches_bf16 = 0


reset_launches()


class GruSeq(torch.autograd.Function):
    """hs = gru_seq(wh, bh, gi_tm, h0), differentiable in all four, in
    float32 or bf16 (the dtype of the inputs picks the kernels' entries).
    On CUDA it saves the forward's residual tape and its backward runs the
    kernels from it; on CPU tensors, or with ``plain``, it runs the plain
    versions, saves the forward's inputs and its backward recomputes the
    gates (``gru_seq_bwd_reference``'s recurrence)."""

    @staticmethod
    def forward(ctx, wh, bh, gi_tm, h0, plain=False):
        ctx.recompute = plain or gi_tm.device.type == "cpu"
        if ctx.recompute:
            hs = gru_seq_reference(wh, bh, gi_tm, h0)
            ctx.save_for_backward(wh, bh, gi_tm, h0, hs)
        else:
            hs, res = gru_seq_fwd(wh, bh, gi_tm, h0)
            ctx.save_for_backward(wh, h0, hs, res)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        if ctx.recompute:
            wh, bh, gi_tm, h0, hs = ctx.saved_tensors
            dhs = dhs.to(hs.dtype)
            dgi, dghn, dh0 = _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs,
                                                       dhs)
            dwh, dbh = _wgrad_reference(h0, hs, dgi, dghn)
        else:
            wh, h0, hs, res = ctx.saved_tensors
            dhs = dhs.to(hs.dtype)
            dgi, dghn, dh0 = gru_seq_bwd(wh, h0, hs, res, dhs)
            dwh, dbh = gru_seq_wgrad(h0, hs, dgi, dghn)
        return dwh, dbh, dgi, dh0, None


def gru_seq(wh, bh, gi_tm, h0):
    """Fused GRU over a whole sequence: wh [H, 3H], bh [3H], gi_tm
    [T, B, 3H] time-major with bi folded in, h0 [B, H] -> hs [T, B, H].
    A call that autograd does not record runs the forward alone, with no
    residual tape."""
    if not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (wh, bh, gi_tm, h0))):
        if in_plain():
            return gru_seq_reference(wh, bh, gi_tm, h0)
        return gru_seq_fwd(wh, bh, gi_tm, h0, residuals=False)[0]
    if in_plain():
        if wh.dtype == torch.bfloat16:
            return GruSeq.apply(wh, bh, gi_tm, h0, True)
        return gru_seq_reference(wh, bh, gi_tm, h0)
    return GruSeq.apply(wh, bh, gi_tm, h0)


# ---- plain versions ---------------------------------------------------------

def gru_seq_reference(wh, bh, gi_tm, h0):
    """Plain torch version of the forward's hs (differentiable by
    autograd in float32; in bf16 ``GruSeq`` gives its gradient)."""
    return gru_seq_res_reference(wh, bh, gi_tm, h0)[0]


def gru_seq_res_reference(wh, bh, gi_tm, h0):
    """Plain torch version of the training forward: a step loop of the
    gates that returns (hs [T, B, H], res [T, B, H, 4]), res holding each
    step's r, z, n and gh_n of each unit. In bf16 at the JAX kernel's
    rounding points (module docstring): hs bf16, res f32."""
    if wh.dtype == torch.bfloat16:
        return _res_reference_bf16(wh, bh, gi_tm, h0)
    H = wh.shape[0]
    h = h0
    hs, res = [], []
    for t in range(gi_tm.shape[0]):
        gi, gh = gi_tm[t], h @ wh + bh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
        res.append(torch.stack([r, z, n, gh[:, 2 * H:]], dim=-1))
    return torch.stack(hs), torch.stack(res)


def _bwd_step(dh, hp, r, z, n, gh_n):
    """One reverse step given the gates: (dgi_t, dghn_t, dgh_t)."""
    dz = dh * (hp - n)
    dn_pre = dh * (1.0 - z) * (1.0 - n * n)
    dr_pre = dn_pre * gh_n * r * (1.0 - r)
    dz_pre = dz * z * (1.0 - z)
    dghn = dn_pre * r
    return (torch.cat([dr_pre, dz_pre, dn_pre], dim=1), dghn,
            torch.cat([dr_pre, dz_pre, dghn], dim=1))


def _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs, dhs):
    if wh.dtype == torch.bfloat16:
        return _bwd_reference_bf16(wh, h0, hs, dhs,
                                   lambda t, hp: _gates_bf16(
                                       gi_tm[t], hp, wh.float(), bh.float()))
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
        dgi[t], dghn[t], dgh = _bwd_step(dh, hp, r, z, n, gh_n)
        dh = dh * z + dgh @ wh.T
    return dgi, dghn, dh


def _bwd_chain_reference(wh, h0, hs, res, dhs):
    """Plain torch version of the CUDA backward: the reverse recurrence
    given the forward's gates (res [T, B, H, 4] of r, z, n, gh_n), with no
    gate recompute. Returns (dgi, dghn, dh0)."""
    if wh.dtype == torch.bfloat16:
        gates = res.unbind(-1)
        return _bwd_reference_bf16(
            wh, h0, hs, dhs,
            lambda t, hp: (gates[0][t], gates[1][t], gates[2][t],
                           gates[3][t]))
    hprev = torch.cat([h0[None], hs[:-1]])
    r, z, n, gh_n = res.unbind(-1)
    dgi = torch.empty((*hs.shape[:2], 3 * hs.shape[2]), dtype=hs.dtype,
                      device=hs.device)
    dghn = torch.empty_like(hs)
    dh = torch.zeros_like(h0)
    for t in range(hs.shape[0] - 1, -1, -1):
        dh = dh + dhs[t]
        dgi[t], dghn[t], dgh = _bwd_step(dh, hprev[t], r[t], z[t], n[t],
                                         gh_n[t])
        dh = dh * z[t] + dgh @ wh.T
    return dgi, dghn, dh


def _wgrad_reference(h0, hs, dgi, dghn):
    """(dwh, dbh); in bf16 summed in f32 and rounded once."""
    H = hs.shape[2]
    hprev = torch.cat([h0[None], hs[:-1]]).reshape(-1, H)
    dgh = torch.cat([dgi[..., :2 * H], dghn], dim=2).reshape(-1, 3 * H)
    if hs.dtype == torch.bfloat16:
        hprev, dgh = hprev.float(), dgh.float()
        return ((hprev.T @ dgh).to(torch.bfloat16),
                dgh.sum(0).to(torch.bfloat16))
    return hprev.T @ dgh, dgh.sum(0)


# ---- the bf16 rounding points -----------------------------------------------
# Where the JAX kernels (``pallas_gru.py`` _fwd_kernel and _bwd_kernel, dt
# bf16) round when XLA evaluates them on the CPU in interpret mode: a bf16
# sum cast straight to f32 (the sigmoid's and the tanh's arguments) is not
# rounded there, so these sums are f32 here; every other bf16 op rounds.
# The CUDA kernels round at the same points.

def _gates_bf16(gi, h, whf, bhf):
    """One step's gates from the bf16 tape row gi [B, 3H] and h [B, H]:
    (r, z, n) in f32, unrounded, and gh_n rounded (as f32): gh = h @ wh +
    bh accumulated in f32 and rounded once; n's argument gi_n + (rounded
    r) * gh_n, the product rounded."""
    H = h.shape[1]
    dt = gi.dtype
    gh = (h.float() @ whf + bhf).to(dt)
    r = torch.sigmoid(gi[:, :H].float() + gh[:, :H].float())
    z = torch.sigmoid(gi[:, H:2 * H].float() + gh[:, H:2 * H].float())
    n = torch.tanh(gi[:, 2 * H:].float()
                   + (r.to(dt) * gh[:, 2 * H:]).float())
    return r, z, n, gh[:, 2 * H:].float()


def _res_reference_bf16(wh, bh, gi_tm, h0):
    """The bf16 training forward: hs (the blend's ops each rounded, from
    the rounded gates) and the f32 residuals of ``_gates_bf16``."""
    dt = wh.dtype
    whf, bhf = wh.float(), bh.float()
    h = h0
    hs, res = [], []
    for t in range(gi_tm.shape[0]):
        r, z, n, gh_n = _gates_bf16(gi_tm[t], h, whf, bhf)
        zb = z.to(dt)
        h = (1.0 - zb) * n.to(dt) + zb * h
        hs.append(h)
        res.append(torch.stack([r, z, n, gh_n], dim=-1))
    return torch.stack(hs), torch.stack(res)


def _bwd_step_bf16(d, hp, r, z, n, gh_n):
    """One reverse step in f32 from the carry d and the step's gates,
    the four gate gradients rounded: (dgi_t, dghn_t, dgh_t as f32)."""
    dt = torch.bfloat16
    dz = d * (hp.float() - n)
    dn_pre = d * (1.0 - z) * (1.0 - n * n)
    dr_pre = dn_pre * gh_n * r * (1.0 - r)
    dz_pre = dz * z * (1.0 - z)
    dr_c, dz_c, dn_c, dgn_c = (a.to(dt) for a in (dr_pre, dz_pre, dn_pre,
                                                  dn_pre * r))
    return (torch.cat([dr_c, dz_c, dn_c], dim=1), dgn_c,
            torch.cat([dr_c, dz_c, dgn_c], dim=1).float())


def _bwd_reference_bf16(wh, h0, hs, dhs, gates):
    """The bf16 reverse recurrence: ``gates(t, h_{t-1})`` gives step t's
    (r, z, n, gh_n); dh carried in f32, dh0 rounded once. Returns (dgi,
    dghn, dh0) in bf16."""
    hprev = torch.cat([h0[None], hs[:-1]])
    T, B, H = hs.shape
    dgi = torch.empty((T, B, 3 * H), dtype=hs.dtype, device=hs.device)
    dghn = torch.empty_like(hs)
    whf_t = wh.float().T
    dh = torch.zeros(h0.shape, dtype=torch.float32, device=h0.device)
    for t in range(T - 1, -1, -1):
        d = dh + dhs[t].float()
        r, z, n, gh_n = gates(t, hprev[t])
        dgi[t], dghn[t], dgh = _bwd_step_bf16(d, hprev[t], r, z, n, gh_n)
        dh = d * z + dgh @ whf_t
    return dgi, dghn, dh.to(hs.dtype)


def gru_seq_bwd_reference(wh, bh, gi_tm, h0, hs, dhs):
    """Plain torch version of the whole backward, the explicit reverse
    recurrence of the JAX kernel's ``_bwd_kernel``: returns (dwh, dbh,
    dgi, dh0) for the incoming dhs [T, B, H]."""
    dgi, dghn, dh0 = _bwd_recurrence_reference(wh, bh, gi_tm, h0, hs, dhs)
    dwh, dbh = _wgrad_reference(h0, hs, dgi, dghn)
    return dwh, dbh, dgi, dh0
