"""The WAE-MMD with the full kernel matrices: CUDA kernels (value and
gradient), their autograd Function and their plain versions.

``mmd_full(z1, z2, sigma, kernel)`` is ``losses.mmd_full_kernel``: for z1,
z2 [N, D], with phi the kernel form of ``compute_mmd_kernel`` as a
function of the squared distance and H = K11 + K22 - 2 K12, the scalar
(sum_ij H_ij - N sum_j H_jj) / (N (N - 1)) -- the JAX package's
``H - diag(H)[None, :]`` quirk, kept exactly. It replaces the TPU kernel of
the JAX package ``ops/pallas_kernels.py:mmd_full_pallas`` (``_mmd_kernel``,
gaussian only) for the gaussian, laplace and energy forms; the CUDA
source, with its design note, is ``csrc/mmd_full.cu``. The gradient is a
kernel too (``mmd_full_bwd``), so ``--vae.z_regu_loss mmd`` trains on the
card: with w = phi'(squared distance),

    dS/dz1_a = 4 / (N (N - 1)) [sum_j w(d11_aj) (z1_a - z1_j)
               - sum_j w(d12_aj) (z1_a - z2_j) + N w(d12_aa) (z1_a - z2_a)],

and S is symmetric in (z1, z2), so z2's gradient is the same kernel with
the arguments swapped. The Function saves z1 and z2 only and launches no
backward unless the value is in the loss (the default ``mmdrf`` run only
logs it).

Scope: float32 (as the JAX kernel's: on bf16 inputs its out_shape is
bf16 and storing its f32 sum there raises), N >= 1, D <= MAX_D (256; the
latent width is 100). At
N 1 both divide 0 by N (N - 1) = 0 and give NaN, as the plain versions
and the JAX package do, so a batch of one row logs a NaN ``L_wae_mmd``
and does not stop a run that regularizes with kl or mmdrf.
Dispatch: CPU tensors run the plain versions (``mmd_full_reference``, the
torch expression of ``losses.py``, and ``mmd_full_bwd_reference``, the
formula above); CUDA tensors launch the kernels or raise, also outside the
scope. ``mmd_full_fwd.launches`` and ``mmd_full_bwd.launches`` count the
wrapper calls that launched kernels (the value is one launch a call: its
last block sums the blocks' partials and resets a completion counter, one
per device and stream, allocated zeroed once by ``_counter``).
``losses.mmd_full_kernel`` takes the plain expression on any device inside
``cuda_build.plain()``.
"""

import ctypes
import threading

import torch

from .cuda_build import compile_library

MAX_D = 256           # the gradient kernel's scope: one thread per feature
FORMS = {"gaussian": 0, "laplace": 1, "energy": 2}

_lib = None
_lib_lock = threading.Lock()
build_log = ""
# (device index, stream handle) -> the value kernel's completion counter
_counters = {}


def build():
    """Compile csrc/mmd_full.cu (once per source content) and load it.
    Returns the ctypes library; the nvcc output is kept in `build_log`."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_library("mmd_full.cu")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mmd_full_fwd_f32.argtypes = [p] * 5 + [i, i, f, i, p]
        lib.mmd_full_bwd_f32.argtypes = [p] * 4 + [i, i, f, i, p]
        lib.mmd_full_blocks.argtypes = [i]
        for fn in (lib.mmd_full_fwd_f32, lib.mmd_full_bwd_f32,
                   lib.mmd_full_blocks, lib.mmd_full_max_d):
            fn.restype = i
        lib.mmd_full_error_string.argtypes = [i]
        lib.mmd_full_error_string.restype = ctypes.c_char_p
        if lib.mmd_full_max_d() != MAX_D:
            raise RuntimeError("csrc/mmd_full.cu and ops/mmd_kernel.py "
                               "disagree on MAX_D")
        _lib = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        msg = lib.mmd_full_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _form(kernel):
    try:
        return FORMS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel}") from None


def _validate(z1, z2):
    """Raise unless z1, z2 are float32 [N, D] on one CUDA device with
    N >= 1 and D <= MAX_D. Returns (N, D)."""
    if z1.dim() != 2 or z1.shape != z2.shape:
        raise ValueError(f"z1 {tuple(z1.shape)} and z2 {tuple(z2.shape)} "
                         f"must both be [N, D]")
    N, D = z1.shape
    if N < 1 or not 1 <= D <= MAX_D:
        raise ValueError(f"shape outside the MMD kernels' scope: N={N} "
                         f"D={D} (need N >= 1, 1 <= D <= {MAX_D})")
    for name, a in (("z1", z1), ("z2", z2)):
        if a.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA MMD kernels take float32, got {a.dtype} for "
                f"{name}: the JAX kernel (ops/pallas_kernels.py:"
                "mmd_full_pallas) takes float32 only, its f32 sum stored "
                "into a bf16 output raises")
    if z2.device != z1.device:
        raise ValueError(f"z2 is on {z2.device}, expected {z1.device}")
    return N, D


def _s2(sigma):
    return float(sigma) ** 2


def _counter(dev, stream):
    """The value kernel's completion counter for launches on ``stream`` (a
    CUDA stream handle) of device ``dev``: one int32, zeroed once here and
    reset to 0 by every launch that uses it, so a call launches no memset;
    a launch on another stream or device gets a counter of its own. A
    counter that exists is returned without the lock."""
    key = (dev.index, stream)
    count = _counters.get(key)
    if count is not None:
        return count
    with _lib_lock:
        if key not in _counters:
            _counters[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
        return _counters[key]


def mmd_full_fwd(z1, z2, sigma, kernel="gaussian"):
    """The scalar S (0-d float32 tensor) of z1, z2 [N, D]."""
    form = _form(kernel)
    if z1.device.type == "cpu":
        return mmd_full_reference(z1, z2, sigma, kernel)
    if z1.device.type != "cuda":
        raise ValueError(f"unsupported device {z1.device}")
    N, D = _validate(z1, z2)
    dev = z1.device
    z1, z2 = z1.detach().contiguous(), z2.detach().contiguous()
    lib = build()
    part = torch.empty((2 * lib.mmd_full_blocks(N),), dtype=torch.float64,
                       device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = _counter(dev, stream)
    with torch.cuda.device(dev):
        code = lib.mmd_full_fwd_f32(
            z1.data_ptr(), z2.data_ptr(), part.data_ptr(), count.data_ptr(),
            out.data_ptr(), N, D, _s2(sigma), form, stream)
    _check(lib, code, "mmd_full_fwd_f32 launch")
    mmd_full_fwd.launches += 1
    return out


def mmd_full_bwd(x, y, gout, sigma, kernel="gaussian"):
    """gout * dS/dx [N, D] for S of (x, y) (S is symmetric: (z2, z1) gives
    z2's gradient); gout is the 0-d upstream gradient."""
    form = _form(kernel)
    if x.device.type == "cpu":
        return mmd_full_bwd_reference(x, y, sigma, kernel) * gout
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    N, D = _validate(x, y)
    dev = x.device
    if gout.numel() != 1 or gout.dtype != torch.float32 or (
            gout.device != dev):
        raise ValueError("gout must be one float32 value on x's device")
    x, y = x.detach().contiguous(), y.detach().contiguous()
    gout = gout.detach().reshape(()).contiguous()
    gx = torch.empty((N, D), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        code = lib.mmd_full_bwd_f32(
            x.data_ptr(), y.data_ptr(), gout.data_ptr(), gx.data_ptr(), N, D,
            _s2(sigma), form, torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, "mmd_full_bwd_f32 launch")
    mmd_full_bwd.launches += 1
    return gx


mmd_full_fwd.launches = 0
mmd_full_bwd.launches = 0


def reset_launches():
    mmd_full_fwd.launches = 0
    mmd_full_bwd.launches = 0


class MmdFull(torch.autograd.Function):
    """S = mmd_full(z1, z2), differentiable in both."""

    @staticmethod
    def forward(ctx, z1, z2, sigma, kernel):
        ctx.sigma, ctx.kernel = sigma, kernel
        ctx.save_for_backward(z1, z2)
        return mmd_full_fwd(z1, z2, sigma, kernel)

    @staticmethod
    def backward(ctx, gout):
        z1, z2 = ctx.saved_tensors
        g1 = g2 = None
        if ctx.needs_input_grad[0]:
            g1 = mmd_full_bwd(z1, z2, gout, ctx.sigma, ctx.kernel)
        if ctx.needs_input_grad[1]:
            g2 = mmd_full_bwd(z2, z1, gout, ctx.sigma, ctx.kernel)
        return g1, g2, None, None


def mmd_full(z1, z2, sigma, kernel="gaussian"):
    """The WAE-MMD of z1, z2 [N, D] through the kernels (the plain versions
    on CPU tensors)."""
    return MmdFull.apply(z1, z2, sigma, kernel)


# ---- plain versions ---------------------------------------------------------

def compute_mmd_kernel(x, y, sigma, kernel):
    """x: [N, d], y: [M, d] -> [N, M] kernel matrix."""
    xmy = ((x[:, None, :] - y[None, :, :]) ** 2).sum(2)
    if kernel == "gaussian":
        return torch.exp(-xmy / sigma ** 2)
    if kernel == "laplace":
        return torch.exp(-torch.sqrt(xmy + sigma ** 2))
    if kernel == "energy":
        return torch.pow(xmy + sigma ** 2, -0.25)
    raise ValueError(f"unknown kernel {kernel}")


def mmd_full_reference(z1, z2, sigma, kernel="gaussian"):
    """Plain torch version of the value (differentiable by autograd)."""
    K11 = compute_mmd_kernel(z1, z1, sigma, kernel)
    K22 = compute_mmd_kernel(z2, z2, sigma, kernel)
    K12 = compute_mmd_kernel(z1, z2, sigma, kernel)
    n = z1.shape[0]
    H = K11 + K22 - 2.0 * K12
    # the reference's quirk: diag(H) broadcast across rows is subtracted
    H = H - torch.diagonal(H)[None, :]
    return H.sum() / (n * (n - 1))


def _dphi(d, sigma, kernel):
    """The kernel form's derivative in the squared distance d."""
    s2 = sigma ** 2
    if kernel == "gaussian":
        return -torch.exp(-d / s2) / s2
    if kernel == "laplace":
        r = torch.sqrt(d + s2)
        return -torch.exp(-r) / (2.0 * r)
    if kernel == "energy":
        return -0.25 * torch.pow(d + s2, -1.25)
    raise ValueError(f"unknown kernel {kernel}")


def mmd_full_bwd_reference(z1, z2, sigma, kernel="gaussian"):
    """Plain torch version of dS/dz1 [N, D] (the formula above)."""
    n = z1.shape[0]
    diff11 = z1[:, None, :] - z1[None, :, :]           # z1_a - z1_j
    diff12 = z1[:, None, :] - z2[None, :, :]           # z1_a - z2_j
    w11 = _dphi((diff11 ** 2).sum(2), sigma, kernel)
    w12 = _dphi((diff12 ** 2).sum(2), sigma, kernel)
    g = ((w11[:, :, None] * diff11).sum(1) - (w12[:, :, None] * diff12).sum(1)
         + n * torch.diagonal(w12)[:, None] * (z1 - z2))
    return 4.0 * g / (n * (n - 1))
