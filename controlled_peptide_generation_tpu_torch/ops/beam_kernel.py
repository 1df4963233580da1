"""The whole-scan GRU beam: CUDA kernel wrapper and its plain version.

``beam_scan_gru`` runs every step of the beam search for a batch of
sentences and returns the per-step tapes; ``ops/beam.py`` turns them into
hypotheses. It replaces the TPU kernel of the JAX package
(``ops/pallas_beam.py:beam_scan_gru``). The CUDA source, with its design
note, is ``csrc/beam_gru.cu``; it is compiled with nvcc for sm_90a at first
use into ``build/torch_kernels/`` and bound with ctypes.

Dispatch: a CPU tensor goes to ``beam_scan_gru_reference`` (plain torch,
the same arithmetic step by step); a CUDA tensor launches the kernel or
raises. float32 inputs launch the entry ``beam_gru_f32``, bfloat16 inputs
``beam_gru_bf16`` (bf16 storage, the cell's and the head's products on
the tensor cores, rounding where the JAX kernel rounds); any other type
raises. The wrapper hands the kernel wh and w_out transposed and padded
(``weight_layout`` in f32, ``mma_layout`` in bf16).
``beam_scan_gru.launches`` and ``beam_scan_gru.launches_bf16`` count the
two entries' launches.
"""

import ctypes
import threading

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX
from . import nn
from .cuda_build import (beam_kernel_name, compile_library, ptxas_usage,
                         read_stamps)

NEG = -1e20
_MAX_V = 128          # kernel scope, as the JAX kernel's `applicable`
_MAX_H = 127
_MAX_TK = 256
# the phases the stamp entries clock, in the kernel's enum Phase order
STAMP_PHASES = ("gru cell", "head", "selection", "reorder")

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def applicable(model, beam_size, dtype):
    """True when beam_search can route through the kernel: the scope of
    the JAX kernel (GRU family without skip connections, V <= 128,
    h_dec <= 127, 1 < K <= V - 2, T*K <= 256, fp32 or bf16)."""
    if model.G_class != "gru" or model.gru_args.get("skip_connections"):
        return False
    if model.max_seq_len * beam_size > _MAX_TK:
        return False
    return (model.n_vocab <= _MAX_V and model.h_dec <= _MAX_H
            and 1 < beam_size <= model.n_vocab - 2
            and dtype in (torch.float32, torch.bfloat16))


def build():
    """Compile csrc/beam_gru.cu (once per source content) and load it.
    Returns the ctypes library; the nvcc output is kept in `build_log`."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_library("beam_gru.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        for entry in (lib.beam_gru_f32, lib.beam_gru_bf16):
            entry.argtypes = [p] * 13 + [i] * 7 + [p]
            entry.restype = i
        for entry in (lib.beam_gru_f32_stamp, lib.beam_gru_bf16_stamp):
            entry.argtypes = [p] * 13 + [i] * 7 + [p, p]
            entry.restype = i
        lib.beam_gru_stamp_words.argtypes = [i]
        for fn in (lib.beam_gru_stamp_words, lib.beam_gru_stamp_phases):
            fn.restype = i
        lib.beam_gru_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.beam_gru_plan.restype = i
        lib.beam_gru_error_string.argtypes = [i]
        lib.beam_gru_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_report(log=None):
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} of csrc/beam_gru.cu, read from ptxas' -v output in the build log
    (``build_log`` by default), named ``<kernel><type, production |
    stamp[, weights via L2]>`` (``cuda_build.beam_kernel_name``)."""
    return ptxas_usage(build_log if log is None else log, beam_kernel_name)


def _check(lib, code, what):
    if code != 0:
        msg = lib.beam_gru_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def weight_layout(wh, w_out):
    """The f32 kernel's transposed, padded copies of wh [H, 3H] and w_out
    [H, V], in their own type: whT [3, HL, LDW]
    with whT[g, j, k] = wh[k, g*H + j] and woT [VP, LDW] with
    woT[v, k] = w_out[k, v], zero elsewhere; HL = 4 NL for
    NL = ceil(H / 4) lanes of 4 units, LDW = 4 (NL | 1) (4 x an odd number,
    so that a quarter-warp's 16-byte loads of consecutive rows hit distinct
    banks), VP = V rounded up to 32. As csrc/beam_gru.cu:make_geo."""
    H, V = w_out.shape
    NL = -(-H // 4)
    HL, LDW, VP = 4 * NL, 4 * (NL | 1), 32 * -(-V // 32)
    whT = wh.new_zeros((3, HL, LDW))
    whT[:, :H, :H] = wh.reshape(H, 3, H).permute(1, 2, 0)
    woT = w_out.new_zeros((VP, LDW))
    woT[:V, :H] = w_out.T
    return whT, woT


def mma_layout(wh, w_out):
    """The bf16 kernel's copies of wh [H, 3H] and w_out [H, V] for its
    tensor-core products, in their own type: whT [3, MU, LDK] with
    whT[g, j, k] = wh[k, g*H + j] and woT [VM, LDK] with woT[v, k] =
    w_out[k, v], zero elsewhere; KP = MU = H rounded up to 16 (one
    m16n8k16 tile), LDK = KP + 8 (LDK / 2 words = 4 mod 8, so that
    ldmatrix's eight 16-byte rows of a phase hit distinct banks), VM = V
    rounded up to 16. As csrc/beam_gru.cu:make_mgeo."""
    H, V = w_out.shape
    KP = 16 * -(-H // 16)
    LDK, VM = KP + 8, 16 * -(-V // 16)
    whT = wh.new_zeros((3, KP, LDK))
    whT[:, :H, :H] = wh.reshape(H, 3, H).permute(1, 2, 0)
    woT = w_out.new_zeros((VM, LDK))
    woT[:V, :H] = w_out.T
    return whT, woT


def launch_plan(B, K, V, H, dtype=torch.float32):
    """(sentences (warps) per block, threads per block, weights in shared
    memory, dynamic shared bytes, grid) the kernel uses at these shapes and
    type."""
    lib = build()
    out = (ctypes.c_int * 5)()
    _check(lib, lib.beam_gru_plan(B, K, V, H, int(dtype == torch.bfloat16),
                                  out), "beam_gru_plan")
    return tuple(out)


def beam_scan_gru(tok_table, zc_gi, wh, bh, w_out, b_out, zc0, *, T, K, V,
                  H, min_length, n_best):
    """Run the whole beam scan. Inputs: tok_table [V, 3H] (signed zeros
    canonicalized), zc_gi [B, 3H] (input bias folded in), wh [H, 3H],
    bh [3H], w_out [H, V], b_out [V], zc0 [B, H].

    Returns (ys [B, T, K] int32, ptr [B, T, K] int32, sc [B, T, K] f32,
    scores [B, K] f32, adv [B] int32, fin_cnt [B] int32)."""
    args = (tok_table, zc_gi, wh, bh, w_out, b_out, zc0)
    if tok_table.device.type == "cpu":
        return beam_scan_gru_reference(*args, T=T, K=K, V=V, H=H,
                                       min_length=min_length, n_best=n_best)
    return _launch(args, T=T, K=K, V=V, H=H, min_length=min_length,
                   n_best=n_best, stamps=None)


def beam_scan_gru_stamped(tok_table, zc_gi, wh, bh, w_out, b_out, zc0, *, T,
                          K, V, H, min_length, n_best):
    """Measurement only (chip_smoke.py, the card tests): the same launch
    through the stamp entry (``beam_gru_*_stamp``), which records each
    phase's clock cycles in two blocks and every block's start and end.
    Returns (the six outputs of ``beam_scan_gru``, the stamps as
    ``cuda_build.read_stamps`` gives them). Counts no launch."""
    lib = build()
    B = zc_gi.shape[0]
    grid = launch_plan(B, K, V, H, tok_table.dtype)[4]
    buf = torch.zeros(lib.beam_gru_stamp_words(grid), dtype=torch.int64,
                      device=tok_table.device)
    out = _launch((tok_table, zc_gi, wh, bh, w_out, b_out, zc0), T=T, K=K,
                  V=V, H=H, min_length=min_length, n_best=n_best,
                  stamps=buf)
    return out, read_stamps(buf, STAMP_PHASES, lib.beam_gru_stamp_phases())


def _launch(args, *, T, K, V, H, min_length, n_best, stamps):
    """Check the CUDA inputs and launch the production entry (stamps None,
    counted) or its stamp instantiation (stamps the int64 buffer)."""
    tok_table = args[0]
    if tok_table.device.type != "cuda":
        raise ValueError(f"unsupported device {tok_table.device}")
    dt = tok_table.dtype
    if dt not in _ENTRIES:
        raise NotImplementedError(
            f"the CUDA beam kernel takes float32 or bfloat16, got {dt}")
    B = args[1].shape[0]
    if not (V <= _MAX_V and H <= _MAX_H and 1 < K <= V - 2
            and T * K <= _MAX_TK):
        raise ValueError(f"shape outside the kernel's scope: T={T} K={K} "
                         f"V={V} H={H}")
    want = {"tok_table": (V, 3 * H), "zc_gi": (B, 3 * H),
            "wh": (H, 3 * H), "bh": (3 * H,), "w_out": (H, V),
            "b_out": (V,), "zc0": (B, H)}
    for name, a in zip(want, args):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {want[name]}")
        if a.dtype != dt or a.device != tok_table.device:
            raise ValueError(f"{name} must be {dt} on {tok_table.device}")
    tok, zc_gi, wh, bh, w_out, b_out, zc0 = (a.contiguous() for a in args)
    whT, woT = (weight_layout if dt == torch.float32 else mma_layout)(
        wh, w_out)
    args = (tok, zc_gi, whT, bh, woT, b_out, zc0)
    dev = tok_table.device
    ys = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    ptr = torch.empty_like(ys)
    sc = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    adv = torch.empty((B,), dtype=torch.int32, device=dev)
    fin = torch.empty_like(adv)
    if B == 0:
        return ys, ptr, sc, scores, adv, fin
    lib = build()
    entry, counter = _ENTRIES[dt]
    extra = () if stamps is None else (stamps.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry if stamps is None else entry + "_stamp")(
            *(a.data_ptr() for a in args),
            *(o.data_ptr() for o in (ys, ptr, sc, scores, adv, fin)),
            B, T, K, V, H, int(min_length), int(n_best), *extra, stream)
    _check(lib, code, f"{entry} launch")
    if stamps is None:
        setattr(beam_scan_gru, counter, getattr(beam_scan_gru, counter) + 1)
    return ys, ptr, sc, scores, adv, fin


# the kernel's entry and its launch counter per input type
_ENTRIES = {torch.float32: ("beam_gru_f32", "launches"),
            torch.bfloat16: ("beam_gru_bf16", "launches_bf16")}
beam_scan_gru.launches = 0
beam_scan_gru.launches_bf16 = 0


def topk_lowest_index(x, k):
    """Top-k along dim 1 with ties to the lowest index: k rounds of
    first-argmax, the found entry masked to -inf between rounds. Needs
    >= k entries above -inf per row (beam rows have them when K <= V - 2);
    otherwise a stable descending sort gives the same order."""
    if k > x.shape[1] - 2:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    cur = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=1, keepdim=True)
        vals.append(torch.gather(cur, 1, i))
        idxs.append(i)
        cur.scatter_(1, i, float("-inf"))
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def advance(logp, scores, prev, adv, *, K, V, min_length):
    """One beam advance for a batch: logp [B, K, V] f32 -> (best [B, K],
    next_y [B, K], prev_k [B, K])."""
    dev = logp.device
    v_ix = torch.arange(V, device=dev)
    wp = torch.where(v_ix == START_IDX, NEG, logp)
    early = (adv + 1 < min_length)[:, None, None] & (v_ix == EOS_IDX)
    wp = torch.where(early, NEG, wp)
    later = wp + scores[:, :, None]
    later = torch.where((prev == EOS_IDX)[:, :, None], NEG, later)
    k0 = (torch.arange(K, device=dev) == 0)[None, :, None]
    first = torch.where(k0, wp, float("-inf"))
    bs = torch.where((adv == 0)[:, None, None], first, later)
    bs = nn.canonical_zeros(bs)
    best, ids = topk_lowest_index(bs.reshape(bs.shape[0], K * V), K)
    return best, ids % V, ids // V


def scan_init(B, K, dev):
    """The beam's bookkeeping state at step 0: scores [B, K] f32, prev
    [B, K] (START in beam 0, PAD elsewhere), adv [B], eos_top [B],
    fin [B]."""
    scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
    prev = torch.full((B, K), PAD_IDX, dtype=torch.long, device=dev)
    prev[:, 0] = START_IDX
    adv = torch.zeros((B,), dtype=torch.int32, device=dev)
    eos_top = torch.zeros((B,), dtype=torch.bool, device=dev)
    fin = torch.zeros((B,), dtype=torch.int32, device=dev)
    return scores, prev, adv, eos_top, fin


def scan_step(logp, state, *, K, V, min_length, n_best):
    """One step of the beam's bookkeeping from logp [B, K, V] f32: the
    advance, then the done gating. Returns (new state, the step's tape
    entries (ys, ptr, sc) [B, K], prev_k [B, K]: the backpointers by which
    the decoder state is reordered, done sentences included)."""
    scores, prev, adv, eos_top, fin = state
    done = eos_top & (fin >= n_best)
    best, next_y, prev_k = advance(logp, scores, prev, adv, K=K, V=V,
                                   min_length=min_length)
    d1 = done[:, None]
    fin = fin + ((next_y == EOS_IDX) & ~d1).sum(1, dtype=torch.int32)
    eos_top = eos_top | ((next_y[:, 0] == EOS_IDX) & ~done)
    state = (torch.where(d1, scores, best), torch.where(d1, prev, next_y),
             torch.where(done, adv, adv + 1), eos_top, fin)
    tape = (torch.where(d1, PAD_IDX, next_y), torch.where(d1, 0, prev_k),
            best)
    return state, tape, prev_k


def scan_tapes(state, tapes):
    """The per-step tape entries and the final state -> (ys, ptr, sc
    [B, T, K], scores [B, K], adv [B], fin [B]), the kernels' outputs."""
    ys, ptr, sc = zip(*tapes)
    scores, _, adv, _, fin = state
    return (torch.stack(ys, 1).int(), torch.stack(ptr, 1).int(),
            torch.stack(sc, 1), scores, adv, fin)


def gru_cell_bf16_points(gi, h, wh, bh):
    """One beam step's GRU cell at the JAX kernel's rounding points in the
    compute type dt of gi and h (``pallas_beam.py:_kernel``, as XLA
    evaluates it on the CPU in interpret mode): gh = h @ wh + bh
    accumulated in f32 and rounded once; r and z the f32 sigmoid of the
    f32 sum gi + gh, rounded (XLA drops the sum's rounding: it is cast
    straight to f32); n the f32 tanh of gi_n plus the rounded r * gh_n;
    the blend with each op rounded. In f32 these are the plain cell's
    ops."""
    dt = gi.dtype
    gh = (h.float() @ wh.float() + bh.float()).to(dt)
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r.float() + h_r.float()).to(dt)
    z = torch.sigmoid(i_z.float() + h_z.float()).to(dt)
    n = torch.tanh(i_n.float() + (r * h_n).float()).to(dt)
    return (1.0 - z) * n + z * h


def beam_scan_gru_reference(tok_table, zc_gi, wh, bh, w_out, b_out, zc0, *,
                            T, K, V, H, min_length, n_best, skip=None):
    """Plain torch version of beam_scan_gru: the same signature, outputs
    and per-step arithmetic, in float32 or bfloat16, on any device. In
    bf16 it rounds where the JAX package's kernel does in interpret mode
    (``gru_cell_bf16_points``; the head accumulated in f32 with its bias
    and rounded once; the log-softmax in f32), which its CPU tests hold
    token-equal.

    ``skip`` (the decoder's ``skip_x`` and ``skip_z`` linear maps) adds the
    skip connections' head, outside the kernel's scope as in the JAX
    package: the head reads skip_x(h) + skip_z(zc0), summed in that order
    before ``w_out`` (folding skip_x into w_out would round otherwise and
    move near-ties), as the JAX package's XLA beam computes it."""
    B = zc_gi.shape[0]
    dt = tok_table.dtype
    tok_table = nn.canonical_zeros(tok_table)
    h = zc0.to(dt)[:, None, :].expand(B, K, H)
    if skip is not None:
        zc_skip = nn.linear(skip[1], zc0.to(dt))[:, None, :]  # [B, 1, H]
    state = scan_init(B, K, zc_gi.device)
    tapes = []
    for _ in range(T):
        gi = tok_table[state[1]] + zc_gi[:, None, :]          # [B, K, 3H]
        h_new = gru_cell_bf16_points(gi, h, wh, bh)           # [B, K, H]
        h_out = (h_new if skip is None
                 else nn.linear(skip[0], h_new) + zc_skip)
        logits = (h_out.float() @ w_out.float() + b_out.float()).to(dt)
        logp = torch.log_softmax(logits.float(), dim=-1)
        state, tape, prev_k = scan_step(logp, state, K=K, V=V,
                                        min_length=min_length, n_best=n_best)
        tapes.append(tape)
        # done sentences' hidden state advances too; nothing observable
        # depends on it (their emissions are gated)
        h = torch.gather(h_new, 1, prev_k[:, :, None].expand(B, K, H))
    return scan_tapes(state, tapes)
