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
``beam_scan_tfm.launches_bf16`` count the two entries' launches. The
wrapper hands the kernel the products' matrices pre-tiled in the order
its products read them (``weight_tiles``) and LayerNorm's parameters in a
pack of their own (``pack_layers``). ``beam_scan_tfm_stamped`` launches
the same kernel compiled with its phase clocks, for measurement only.
"""

import ctypes
import threading

import torch

from ..models import transformer as tfm
from . import nn
from .beam_kernel import scan_init, scan_step, scan_tapes
from .cuda_build import (beam_kernel_name, compile_library, ptxas_usage,
                         read_stamps)

_D = 128              # kernel scope, as the JAX kernel's `applicable`
_MAX_V = 127
_MAX_S = 32
_MAX_TK = 256
# the phases the stamp entries clock, in the kernel's enum Phase order
# (each layer phase summed over the layers)
STAMP_PHASES = ("embed", "ln1", "qkv", "kv write", "attention", "out", "ln2",
                "ff1", "ff2", "final ln + head", "selection", "reorder")

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
        for entry in (lib.tfm_beam_f32, lib.tfm_beam_bf16,
                      lib.tfm_beam_bf16_mma):
            entry.argtypes = [p] * 17 + [i] * 10 + [p]
        for entry in (lib.tfm_beam_f32_stamp, lib.tfm_beam_bf16_stamp):
            entry.argtypes = [p] * 17 + [i] * 10 + [p, p]
        lib.tfm_beam_stamp_words.argtypes = [i]
        for entry in (lib.tfm_beam_f32, lib.tfm_beam_bf16,
                      lib.tfm_beam_bf16_mma, lib.tfm_beam_f32_stamp,
                      lib.tfm_beam_bf16_stamp,
                      lib.tfm_beam_stamp_words, lib.tfm_beam_stamp_phases):
            entry.restype = i
        lib.tfm_beam_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        lib.tfm_beam_plan.restype = i
        lib.tfm_beam_error_string.argtypes = [i]
        lib.tfm_beam_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_report(log=None):
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} of csrc/tfm_beam.cu, read from ptxas' -v output in the build log
    (``build_log`` by default), named ``<kernel><type, production |
    stamp[, weights via L2]>`` (``cuda_build.beam_kernel_name``)."""
    return ptxas_usage(build_log if log is None else log, beam_kernel_name)


def _check(lib, code, what):
    if code != 0:
        msg = lib.tfm_beam_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_plan(B, K, V, S, F, dtype=torch.float32):
    """(sentences per block, threads per block, dynamic shared bytes,
    blocks resident on the card at once) the kernel uses at these shapes
    and type."""
    lib = build()
    out = (ctypes.c_int * 4)()
    _check(lib, lib.tfm_beam_plan(B, K, V, S, F, int(dtype == torch.bfloat16),
                                  out), "tfm_beam_plan")
    return tuple(out)


# each layer's leaves, as the wrapper checks them
_LAYER_LEAVES = (("ln1", "g"), ("ln1", "b"), ("qkv", "w"), ("qkv", "b"),
                 ("attn_out", "w"), ("attn_out", "b"), ("ln2", "g"),
                 ("ln2", "b"), ("ff1", "w"), ("ff1", "b"), ("ff2", "w"),
                 ("ff2", "b"))


def _layer_shapes(D, F):
    return ((D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,),
            (D, F), (F,), (F, D), (D,))


# the leaves the kernel reads in f32 whatever the storage type
_F32_LEAVES = ("ln1", "ln2")
# the kernel's packs, per layer: the products' matrices pre-tiled, then
# their biases (storage type); LayerNorm's parameters (f32)
_PRODUCTS = ("qkv", "attn_out", "ff1", "ff2")
_LN_LEAVES = (("ln1", "g"), ("ln1", "b"), ("ln2", "g"), ("ln2", "b"))


def weight_tiles(w, dtype):
    """A weight matrix w [Kd, N] (x @ w; N a multiple of 128) in the order
    the kernel's products read it: per chunk of 128 columns, [8 warps]
    [Kd/4 k steps][8 column pairs][2 columns][4 k], so that lane (rg, cg)
    of warp w reads the 8 weights of its columns 16w + 2cg, +1 at one 4-k
    step as 8 contiguous values. Returns a flat tensor of ``dtype``."""
    Kd, N = w.shape
    t = w.to(dtype).reshape(Kd // 4, 4, N // 128, 8, 8, 2)  # kk kq n w cg c
    return t.permute(2, 3, 0, 4, 5, 1).reshape(-1)


def weight_untile(tiles, Kd, N):
    """The matrix [Kd, N] that ``weight_tiles`` tiled."""
    t = tiles.reshape(N // 128, 8, Kd // 4, 8, 2, 4)        # n w kk cg c kq
    return t.permute(2, 5, 0, 1, 3, 4).reshape(Kd, N)


def pack_layers(layers, dtype):
    """The kernel's two packs of the blocks' parameters: per layer the four
    products' matrices (``weight_tiles``), then their biases, in ``dtype``;
    and LayerNorm's ln1 g, b, ln2 g, b per layer in f32."""
    wpack = torch.cat([
        part for lp in layers for part in (
            *(weight_tiles(lp[blk]["w"], dtype) for blk in _PRODUCTS),
            *(lp[blk]["b"].reshape(-1).to(dtype) for blk in _PRODUCTS))])
    lnpack = torch.cat([lp[blk][leaf].reshape(-1).float() for lp in layers
                        for blk, leaf in _LN_LEAVES])
    return wpack, lnpack


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
    args = (tok_table, pos_table, layers, lnf_g, lnf_b, w_out, b_out, k0s,
            v0s)
    if tok_table.device.type == "cpu":
        return beam_scan_tfm_reference(*args, **kw)
    return _launch(*args, **kw, stamps=None)


def beam_scan_tfm_stamped(tok_table, pos_table, layers, lnf_g, lnf_b, w_out,
                          b_out, k0s, v0s, *, T, K, V, S, H, F, min_length,
                          n_best):
    """Measurement only (chip_smoke.py, the card tests): the same launch
    through the stamp entry (``tfm_beam_*_stamp``), which records each
    phase's clock cycles in two blocks and every block's start and end.
    Returns (the six outputs of ``beam_scan_tfm``, the stamps as
    ``cuda_build.read_stamps`` gives them). Counts no launch."""
    lib = build()
    B = k0s[0].shape[0]
    grid = -(-B // launch_plan(B, K, V, S, F, tok_table.dtype)[0])
    buf = torch.zeros(lib.tfm_beam_stamp_words(grid), dtype=torch.int64,
                      device=tok_table.device)
    out = _launch(tok_table, pos_table, layers, lnf_g, lnf_b, w_out, b_out,
                  k0s, v0s, T=T, K=K, V=V, S=S, H=H, F=F,
                  min_length=min_length, n_best=n_best, stamps=buf)
    return out, read_stamps(buf, STAMP_PHASES, lib.tfm_beam_stamp_phases())


def beam_scan_tfm_mma(tok_table, pos_table, layers, lnf_g, lnf_b, w_out,
                      b_out, k0s, v0s, *, T, K, V, S, H, F, min_length,
                      n_best):
    """Measurement only (``tools/tfm_beam_mma.py``): the bf16 kernel with
    its four products on the tensor cores (entry ``tfm_beam_bf16_mma``,
    csrc/tfm_beam.cu:gemm_mma), the alternative the production entry does
    not take because its decodes miss chip_smoke.py's bf16 gate (d). The
    same inputs and outputs as ``beam_scan_tfm`` on bf16 inputs. Counts no
    launch."""
    if tok_table.dtype != torch.bfloat16:
        raise NotImplementedError("the tensor-core variant is bf16 only")
    return _launch(tok_table, pos_table, layers, lnf_g, lnf_b, w_out, b_out,
                   k0s, v0s, T=T, K=K, V=V, S=S, H=H, F=F,
                   min_length=min_length, n_best=n_best, stamps=None,
                   entry="tfm_beam_bf16_mma")


def _launch(tok_table, pos_table, layers, lnf_g, lnf_b, w_out, b_out, k0s,
            v0s, *, T, K, V, S, H, F, min_length, n_best, stamps,
            entry=None):
    """Check the CUDA inputs, pack them and launch the production entry
    (stamps None, counted), its stamp instantiation (stamps the int64
    buffer) or the named measurement ``entry`` (not counted)."""
    dev = tok_table.device
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
    k0 = torch.stack(list(k0s)).contiguous()                  # [L, B, D]
    v0 = torch.stack(list(v0s)).contiguous()
    ins = tuple(_aligned(a) for a in (
        tok_table, pos_table, *pack_layers(layers, dt), lnf_g.float(),
        lnf_b.float(), w_out.float(), b_out.float(), k0, v0))
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
    counted = stamps is None and entry is None
    if entry is None:
        entry, counter = _ENTRIES[dt]
        entry = entry if stamps is None else entry + "_stamp"
    extra = () if stamps is None else (stamps.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            *(a.data_ptr() for a in ins), scratch.data_ptr(),
            *(o.data_ptr() for o in (ys, ptr, sc, scores, adv, fin)),
            B, T, K, V, S, L, H, F, int(min_length), int(n_best), *extra,
            stream)
    _check(lib, code, f"{entry} launch")
    if counted:
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
