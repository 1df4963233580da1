"""The whole-scan transformer beam: CUDA kernel wrapper and its plain version.

``beam_scan_tfm`` runs every step of the beam search of the transformer
decoder for a batch of sentences and returns the same per-step tapes as
the GRU beam (``ops/beam_kernel.py``); ``ops/beam.py`` turns them into
hypotheses. It replaces the TPU kernel of the JAX package
(``ops/pallas_tfm_beam.py:beam_scan_tfm``). The CUDA source, with its
design note, is ``csrc/tfm_beam.cu``; it is compiled with nvcc for sm_90a
at first use into ``build/torch_kernels/`` and bound with ctypes.

Inputs are the decoder folded as the JAX package folds it for its kernel:
tok_table [V, D] = emb (PAD row zeroed) @ in.w + in.b with signed zeros
canonicalized, pos_table [S, D], the blocks' parameters in their
checkpoint layout (qkv columns head-major [H, 3, Dh], no permutation), the
final LayerNorm and head, and the latent prefix's position-0 cache rows
k0s/v0s (one [B, D] per layer, from ``models/transformer.init_cache``).

Dispatch: a CPU tensor goes to ``beam_scan_tfm_reference`` (plain torch,
the generic reorder scan: each step runs ``_block_step`` of every layer on
all B*K lanes and reorders the KV caches by backpointer); a CUDA tensor
launches the kernel or raises. A float32 token table launches the entry
``tfm_beam_f32``, a bfloat16 one ``tfm_beam_bf16`` (the tables, the
products' weights and biases and the prefix rows in bf16; LayerNorm's
parameters, the final LN and the head read in f32, as the JAX kernel
takes them); any other type raises. ``beam_scan_tfm.launches`` and
``beam_scan_tfm.launches_bf16`` count the two entries' launches.
"""

import ctypes
import threading

import torch

from ..models import transformer as tfm
from . import nn
from .beam_kernel import scan_init, scan_step, scan_tapes
from .cuda_build import compile_library

_D = 128              # kernel scope, as the JAX kernel's `applicable`
_MAX_V = 127
_MAX_S = 32
_MAX_TK = 256

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def applicable(model, beam_size, dtype):
    """True when beam_search can route the transformer family through the
    kernel: the JAX kernel's scope (d_model 128, d_ff a multiple of 128,
    n_heads dividing 128, V <= 127, max_seq_len + 1 <= 32, 1 < K <= V - 2,
    T*K <= 256) in float32 or bfloat16."""
    if model.G_class != "transformer":
        return False
    t = model.dec_tfm_args
    D = t.get("d_model", 128)
    F = t.get("d_ff", 4 * D)
    H = t.get("n_heads", 4)
    if D != _D or F % _D or H <= 0 or _D % H:
        return False
    if model.max_seq_len + 1 > _MAX_S:
        return False
    if model.max_seq_len * beam_size > _MAX_TK:
        return False
    return (model.n_vocab <= _MAX_V and 1 < beam_size <= model.n_vocab - 2
            and dtype in (torch.float32, torch.bfloat16))


def build():
    """Compile csrc/tfm_beam.cu (once per source content) and load it.
    Returns the ctypes library; the nvcc output is kept in `build_log`."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = compile_library("tfm_beam.cu")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tfm_beam_f32.argtypes = [p] * 16 + [i] * 10 + [p]
        lib.tfm_beam_bf16.argtypes = [p] * 17 + [i] * 10 + [p]
        for entry in (lib.tfm_beam_f32, lib.tfm_beam_bf16):
            entry.restype = i
        lib.tfm_beam_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
        lib.tfm_beam_plan.restype = i
        lib.tfm_beam_error_string.argtypes = [i]
        lib.tfm_beam_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, code, what):
    if code != 0:
        msg = lib.tfm_beam_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_plan(B, K, V, S, F):
    """(sentences per block, threads per block, dynamic shared bytes) the
    kernel uses at these shapes."""
    lib = build()
    out = (ctypes.c_int * 3)()
    _check(lib, lib.tfm_beam_plan(B, K, V, S, F, out), "tfm_beam_plan")
    return tuple(out)


# per-layer order of the packed weights the kernel reads
_LAYER_LEAVES = (("ln1", "g"), ("ln1", "b"), ("qkv", "w"), ("qkv", "b"),
                 ("attn_out", "w"), ("attn_out", "b"), ("ln2", "g"),
                 ("ln2", "b"), ("ff1", "w"), ("ff1", "b"), ("ff2", "w"),
                 ("ff2", "b"))


def _layer_shapes(D, F):
    return ((D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,),
            (D, F), (F,), (F, D), (D,))


# the leaves the kernel reads in f32 whatever the storage type
_F32_LEAVES = ("ln1", "ln2")


def _aligned(a):
    """a contiguous, at a 16-byte boundary (the kernel's vector loads)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def beam_scan_tfm(tok_table, pos_table, layers, lnf_g, lnf_b, w_out, b_out,
                  k0s, v0s, *, T, K, V, S, H, F, min_length, n_best):
    """Run the whole beam scan of the transformer decoder (inputs: see the
    module docstring). Returns (ys [B, T, K] int32, ptr [B, T, K] int32,
    sc [B, T, K] f32, scores [B, K] f32, adv [B] int32, fin_cnt [B]
    int32)."""
    kw = dict(T=T, K=K, V=V, S=S, H=H, F=F, min_length=min_length,
              n_best=n_best)
    dev = tok_table.device
    if dev.type == "cpu":
        return beam_scan_tfm_reference(tok_table, pos_table, layers, lnf_g,
                                       lnf_b, w_out, b_out, k0s, v0s, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dt = tok_table.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"the CUDA transformer beam kernel takes float32 or bfloat16, "
            f"got {dt}")
    B, L, D = k0s[0].shape[0], len(layers), _D
    if not (tok_table.shape[1] == D and F % D == 0 and F > 0 and H > 0
            and D % H == 0 and V <= _MAX_V and S <= _MAX_S and T + 1 <= S
            and 1 < K <= V - 2 and T * K <= _MAX_TK and L >= 1
            and len(k0s) == len(v0s) == L):
        raise ValueError(f"shape outside the kernel's scope: T={T} K={K} "
                         f"V={V} S={S} H={H} F={F} L={L} "
                         f"D={tok_table.shape[1]}")
    # (tensor, shape, stored in f32): in bf16 the LayerNorm parameters, the
    # final LN and the head may come as f32 or bf16 and are read in f32
    named = {"tok_table": (tok_table, (V, D), False),
             "pos_table": (pos_table, (S, D), False),
             "lnf_g": (lnf_g, (D,), True), "lnf_b": (lnf_b, (D,), True),
             "w_out": (w_out, (D, V), True), "b_out": (b_out, (V,), True)}
    for l, lp in enumerate(layers):
        for (blk, leaf), shape in zip(_LAYER_LEAVES, _layer_shapes(D, F)):
            named[f"layers[{l}].{blk}.{leaf}"] = (lp[blk][leaf], shape,
                                                  blk in _F32_LEAVES)
    for l in range(L):
        named[f"k0s[{l}]"] = (k0s[l], (B, D), False)
        named[f"v0s[{l}]"] = (v0s[l], (B, D), False)
    for name, (a, shape, f32) in named.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{shape}")
        ok = (a.dtype == dt or (f32 and a.dtype in (torch.float32,
                                                     torch.bfloat16)))
        if not ok or a.device != dev:
            raise ValueError(f"{name} must be {dt} on {dev}")
    # one pack per layer in the order of _LAYER_LEAVES, in the storage type;
    # in bf16 a second, f32 pack of the same layout gives LayerNorm its
    # parameters
    pack = torch.cat([lp[blk][leaf].reshape(-1).float() for lp in layers
                      for blk, leaf in _LAYER_LEAVES])
    k0 = torch.stack(list(k0s)).contiguous()                  # [L, B, D]
    v0 = torch.stack(list(v0s)).contiguous()
    packs = (pack,) if dt == torch.float32 else (pack.to(dt), pack)
    ins = tuple(_aligned(a) for a in (
        tok_table, pos_table, *packs, lnf_g.float(), lnf_b.float(),
        w_out.float(), b_out.float(), k0, v0))
    ys = torch.empty((B, T, K), dtype=torch.int32, device=dev)
    ptr = torch.empty_like(ys)
    sc = torch.empty((B, T, K), dtype=torch.float32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    adv = torch.empty((B,), dtype=torch.int32, device=dev)
    fin = torch.empty_like(adv)
    if B == 0:
        return ys, ptr, sc, scores, adv, fin
    # every lane's own KV rows: [B, K, L, 2, S, D], written once per step
    scratch = torch.empty((B, K, L, 2, S, D), dtype=dt, device=dev)
    lib = build()
    entry, counter = _ENTRIES[dt]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            *(a.data_ptr() for a in ins), scratch.data_ptr(),
            *(o.data_ptr() for o in (ys, ptr, sc, scores, adv, fin)),
            B, T, K, V, S, L, H, F, int(min_length), int(n_best), stream)
    _check(lib, code, f"{entry} launch")
    setattr(beam_scan_tfm, counter, getattr(beam_scan_tfm, counter) + 1)
    return ys, ptr, sc, scores, adv, fin


# the kernel's entry and its launch counter per storage type
_ENTRIES = {torch.float32: ("tfm_beam_f32", "launches"),
            torch.bfloat16: ("tfm_beam_bf16", "launches_bf16")}
beam_scan_tfm.launches = 0
beam_scan_tfm.launches_bf16 = 0


def beam_scan_tfm_reference(tok_table, pos_table, layers, lnf_g, lnf_b,
                            w_out, b_out, k0s, v0s, *, T, K, V, S, H, F,
                            min_length, n_best):
    """Plain torch version of beam_scan_tfm: the same signature and
    outputs, as the generic reorder scan over B*K lanes (the JAX package's
    ``ops/beam.py`` scan with ``apply_step``) on the folded inputs, in any
    dtype and on any device."""
    del F
    B = k0s[0].shape[0]
    D = tok_table.shape[1]
    dt = tok_table.dtype
    dev = tok_table.device
    tok_table = nn.canonical_zeros(tok_table)
    cks, cvs = [], []
    for rows, out in ((k0s, cks), (v0s, cvs)):
        for r in rows:
            c = torch.zeros((B * K, S, D), dtype=dt, device=dev)
            c[:, 0] = r.to(dt).repeat_interleave(K, dim=0)
            out.append(c)
    lnf = {"g": lnf_g, "b": lnf_b}
    head = {"w": w_out, "b": b_out}
    lane0 = (torch.arange(B, device=dev) * K)[:, None]
    state = scan_init(B, K, dev)
    tapes = []
    for t in range(T):
        x = (tok_table[state[1]] + pos_table[t + 1]).to(dt).reshape(B * K, D)
        pos = torch.full((B * K,), t + 1, dtype=torch.int32, device=dev)
        for l, p in enumerate(layers):
            x, cks[l], cvs[l] = tfm._block_step(p, x, cks[l], cvs[l], pos, H,
                                                write_pos=t + 1)
        xf = tfm.final_ln(lnf, x, dt)
        logp = torch.log_softmax(nn.linear(head, xf).float(), dim=-1)
        state, tape, prev_k = scan_step(logp.reshape(B, K, V), state, K=K,
                                        V=V, min_length=min_length,
                                        n_best=n_best)
        tapes.append(tape)
        # the generic scan reorders every lane's caches by backpointer,
        # done sentences included (nothing observable depends on theirs)
        src = (lane0 + prev_k).reshape(B * K)
        cks = [c[src] for c in cks]
        cvs = [c[src] for c in cvs]
    return scan_tapes(state, tapes)
