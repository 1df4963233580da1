"""The whole-scan GRU beam: CUDA kernel wrapper and its plain version.

``beam_scan_gru`` runs every step of the beam search for a batch of
sentences and returns the per-step tapes; ``ops/beam.py`` turns them into
hypotheses. It replaces the TPU kernel of the JAX package
(``ops/pallas_beam.py:beam_scan_gru``). The CUDA source, with its design
note, is ``csrc/beam_gru.cu``; it is compiled with nvcc for sm_90a at first
use into ``build/torch_kernels/`` and bound with ctypes.

Dispatch: a CPU tensor goes to ``beam_scan_gru_reference`` (plain torch,
the same arithmetic step by step); a CUDA tensor launches the kernel or
raises. ``beam_scan_gru.launches`` counts kernel launches.
"""

import ctypes
import threading

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX
from . import nn
from .cuda_build import compile_library
from .gru import _gates

NEG = -1e20
_MAX_V = 128          # kernel scope, as the JAX kernel's `applicable`
_MAX_H = 127
_MAX_TK = 256

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
        lib.beam_gru_f32.argtypes = [p] * 13 + [i] * 7 + [p]
        lib.beam_gru_f32.restype = i
        lib.beam_gru_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.beam_gru_plan.restype = i
        lib.beam_gru_error_string.argtypes = [i]
        lib.beam_gru_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        msg = lib.beam_gru_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_plan(B, K, V, H):
    """(sentences per block, threads per block, weights in shared memory,
    dynamic shared bytes) the kernel uses at these shapes."""
    lib = build()
    out = (ctypes.c_int * 4)()
    _check(lib, lib.beam_gru_plan(B, K, V, H, out), "beam_gru_plan")
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
    if tok_table.device.type != "cuda":
        raise ValueError(f"unsupported device {tok_table.device}")
    if tok_table.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA beam kernel takes float32, got {tok_table.dtype} "
            f"(bf16 is queued in ROADMAP.md)")
    B = zc_gi.shape[0]
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
        if a.dtype != torch.float32 or a.device != tok_table.device:
            raise ValueError(f"{name} must be float32 on {tok_table.device}")
    args = tuple(a.contiguous() for a in args)
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.beam_gru_f32(
            *(a.data_ptr() for a in args),
            *(o.data_ptr() for o in (ys, ptr, sc, scores, adv, fin)),
            B, T, K, V, H, int(min_length), int(n_best), stream)
    _check(lib, code, "beam_gru_f32 launch")
    beam_scan_gru.launches += 1
    return ys, ptr, sc, scores, adv, fin


beam_scan_gru.launches = 0


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


def beam_scan_gru_reference(tok_table, zc_gi, wh, bh, w_out, b_out, zc0, *,
                            T, K, V, H, min_length, n_best):
    """Plain torch version of beam_scan_gru: the same signature, outputs
    and per-step arithmetic, in any dtype and on any device."""
    B = zc_gi.shape[0]
    dev = zc_gi.device
    dt = tok_table.dtype
    tok_table = nn.canonical_zeros(tok_table)
    gru = {"wh": wh, "bh": bh}
    h = zc0.to(dt)[:, None, :].expand(B, K, H)
    scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
    prev = torch.full((B, K), PAD_IDX, dtype=torch.long, device=dev)
    prev[:, 0] = START_IDX
    adv = torch.zeros((B,), dtype=torch.int32, device=dev)
    eos_top = torch.zeros((B,), dtype=torch.bool, device=dev)
    fin = torch.zeros((B,), dtype=torch.int32, device=dev)
    ys_t, ptr_t, sc_t = [], [], []
    for _ in range(T):
        gi = tok_table[prev] + zc_gi[:, None, :]              # [B, K, 3H]
        h_new = _gates(gi, h @ gru["wh"] + gru["bh"], h)      # [B, K, H]
        logits = h_new @ w_out + b_out                        # [B, K, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        done = eos_top & (fin >= n_best)
        best, next_y, prev_k = advance(logp, scores, prev, adv, K=K, V=V,
                                       min_length=min_length)
        # done sentences' hidden state advances too; nothing observable
        # depends on it (their emissions are gated below)
        h = torch.gather(h_new, 1, prev_k[:, :, None].expand(B, K, H))
        d1 = done[:, None]
        fin = fin + ((next_y == EOS_IDX) & ~d1).sum(1, dtype=torch.int32)
        eos_top = eos_top | ((next_y[:, 0] == EOS_IDX) & ~done)
        scores = torch.where(d1, scores, best)
        prev = torch.where(d1, prev, next_y)
        adv = torch.where(done, adv, adv + 1)
        ys_t.append(torch.where(d1, PAD_IDX, next_y))
        ptr_t.append(torch.where(d1, 0, prev_k))
        sc_t.append(best)
    return (torch.stack(ys_t, 1).int(), torch.stack(ptr_t, 1).int(),
            torch.stack(sc_t, 1), scores, adv, fin)
