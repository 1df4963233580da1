"""The transformer family: encoder, teacher-forced decoder and the cached
free-running step.

The port of the JAX package's ``models/transformer.py``, with its
parameter names and layouts, so checkpoints cross unchanged:

* pre-LN blocks, learned positions; the decoder is conditioned by a
  latent prefix, proj(z ++ c) at position 0, which every token attends to;
* the fused qkv projection keeps its head-major column layout
  ``[h0(q, k, v), h1(q, k, v), ...]`` (logical ``[D, H, 3, Dh]``);
* attention logits are f32, divided by sqrt(Dh), masked at -1e30; the
  probabilities are rounded to the compute type before the value sum,
  which accumulates in f32 and is rounded once;
* LayerNorm (eps 1e-6 inside the rsqrt) and the tanh GELU run in f32 and
  are cast back (``ops/nn.py``);
* optional bfloat16 compute for the blocks (parameters stay f32 at rest).

The cached step rounds in bfloat16 where the JAX package's step and its
whole-scan kernel round when XLA runs them on the CPU: each product is
accumulated in f32 and rounded, its bias added in the compute type; the
attention as above; LayerNorm reads the residual stream's f32 sum before
its rounding, and the GELU the f32 sum of ff1's rounded product and its
bias (XLA drops a bf16 rounding that is cast straight back to f32), while
the residual adds take the rounded values. In f32 these are the same ops
as the plain forms.

The free-running step carries a KV cache ``{'k': [L x [B, S, D]], 'v':
..., 'pos': [B]}`` with S = max_seq_len + 1 and the latent prefix at
position 0; every engine advances all lanes in lockstep, so the write
position is uniform. The beam search runs the whole decode in one CUDA
kernel (``ops/tfm_beam_kernel.py``); these functions are its reference and
the model's other paths. Not ported: the no-reorder ancestry arm
(``anc_init``/``apply_step_anc``).

Model parallelism (``parallel/tp.py``, ``parallel/pp.py``) reaches the
full-sequence passes alone: given the model group (``tp``), a block runs
its rank's heads and FF units between Megatron's two operators; given a
``blocks_apply`` (the GPipe schedule) the encoder and the teacher-forced
decoder hand their block stack to it, as the JAX package's do. The cached
step runs on whole blocks.

Random draws (word dropout, block dropout) come from a
``torch.Generator`` or are passed in as masks.
"""

import torch

from ..data.vocab import UNK_IDX
from ..ops import nn


def _init_block(gen, d_model, d_ff, device="cpu"):
    """One pre-LN block's params; qkv's output columns are head-major
    [H, 3, Dh] (see the module docstring)."""
    return {
        "ln1": nn.init_layer_norm(d_model, device),
        "qkv": nn.init_linear(gen, d_model, 3 * d_model, device),
        "attn_out": nn.init_linear(gen, d_model, d_model, device),
        "ln2": nn.init_layer_norm(d_model, device),
        "ff1": nn.init_linear(gen, d_model, d_ff, device),
        "ff2": nn.init_linear(gen, d_ff, d_model, device),
    }


def _unpack_qkv(qkv, n_heads):
    """[..., 3D] head-major fused projection -> q, k, v each
    [..., H, Dh]."""
    *lead, d3 = qkv.shape
    dh = d3 // (3 * n_heads)
    qkv = qkv.reshape(*lead, n_heads, 3, dh)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def _split_heads(x, n_heads):
    B, S, D = x.shape
    return x.reshape(B, S, n_heads, D // n_heads)


def compute_dtype(params, bf16):
    """The decoder's compute type: bfloat16 when the flag is on or the
    weights already are bf16 (the fused round casts the whole tree)."""
    if bf16 or params["out"]["w"].dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _enc_compute_dtype(params, bf16):
    if bf16 or params["mu"]["w"].dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _attention(q, k, v, mask):
    """q [B, Sq, H, Dh], k/v [B, Sk, H, Dh], mask broadcastable to
    [B, H, Sq, Sk] (True = attend)."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / torch.sqrt(torch.tensor(dh, dtype=torch.float32))
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def _block_full(p, x, mask, n_heads, p_dropout=0.0, train=False, gen=None,
                keep=None, tp=None):
    """Pre-LN block over a full sequence, x [B, S, D]; ``keep`` is the
    block's dropout mask (drawn from ``gen`` when not given). With ``tp``
    (the model group's ``collectives.Shard``) ``p`` holds the rank's
    slices (``parallel/tp.py``): its n_heads / tp heads and d_ff / tp
    units run between ``tp.enter`` and ``tp.leave``, the row-parallel
    biases added after the sum; the dropout mask is the whole block
    output's, the same on every rank."""
    h = nn.layer_norm(p["ln1"], x)
    if tp is not None:
        h = tp.enter(h)
        n_heads //= tp.world
    q, k, v = _unpack_qkv(nn.linear(p["qkv"], h), n_heads)
    a = _attention(q, k, v, mask).reshape(*x.shape[:-1], -1)
    x = x + _row_linear(p["attn_out"], a, tp)
    h = nn.layer_norm(p["ln2"], x)
    if tp is not None:
        h = tp.enter(h)
    h = _row_linear(p["ff2"], nn.gelu(nn.linear(p["ff1"], h).float()).to(
        x.dtype), tp)
    h = nn.dropout(h, p_dropout, train, gen, keep)
    return x + h


def _row_linear(p, x, tp):
    """x @ w + b; with ``tp`` a row-parallel product, its partial sums
    added over the group before the bias."""
    if tp is None:
        return nn.linear(p, x)
    return tp.leave(nn.matmul(x, p["w"])) + p["b"]


def _lin32(p, x, dt):
    """x @ w + b at the compute type's rounding points, returned in f32
    before its final rounding: the product accumulated in f32 and rounded
    to dt, then the bias (in dt) added."""
    return (x.float() @ p["w"].float()).to(dt).float() + p["b"].to(dt).float()


def _ln_dt(p, x, dt):
    """LayerNorm of x's f32 value (f32 math, as nn.layer_norm), rounded to
    dt."""
    return nn.layer_norm(p, x.float()).to(dt)


def _block_step(p, x, cache_k, cache_v, pos, n_heads, write_pos=None):
    """One token through a block with its KV cache: x [B, D] the residual
    stream entering it (its f32 value feeds LN1, its value in the compute
    type the residual add), cache_k/v [B, S, D], pos [B] (uniform) the
    write position, also given as an int in ``write_pos`` by callers that
    know it (saves a device sync). Returns (y, new_k, new_v), y [B, D] the
    block's output sum in f32 before its rounding to the compute type; the
    given caches are not modified."""
    B, S, D = cache_k.shape
    dt = p["qkv"]["w"].dtype
    h = _ln_dt(p["ln1"], x, dt)
    q, k, v = _unpack_qkv(_lin32(p["qkv"], h, dt).to(dt), n_heads)
    p0 = int(pos[0]) if write_pos is None else write_pos
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[:, p0] = k.reshape(B, D).to(cache_k.dtype)
    cache_v[:, p0] = v.reshape(B, D).to(cache_v.dtype)
    mask = (torch.arange(S, device=x.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    a = _attention(q[:, None], _split_heads(cache_k, n_heads),
                   _split_heads(cache_v, n_heads), mask).reshape(B, D)
    x = x.to(dt).float() + _lin32(p["attn_out"], a, dt).to(dt).float()
    h = _ln_dt(p["ln2"], x, dt)
    h = nn.gelu(_lin32(p["ff1"], h, dt)).to(dt)
    return (x.to(dt).float() + _lin32(p["ff2"], h, dt).to(dt).float(),
            cache_k, cache_v)


def _entry(a, b, dt):
    """(a + b) cast to the compute type, as the stream entering the first
    block: a sum of f32 operands is rounded to dt; a sum in dt keeps its f32
    value for LN1 (XLA drops its rounding there), the residual rounds it."""
    s = a.float() + b.float()
    return s if a.dtype == dt and dt != torch.float32 else s.to(dt)


def final_ln(ln_f, x, dt):
    """The final LayerNorm of the stream's f32 value, rounded to the compute
    type and read back in f32 (the head's input)."""
    return _ln_dt(ln_f, x, dt).float()


# ---- encoder: tokens -> (mu, logvar) ----------------------------------------

def init_encoder(gen, emb_dim, z_dim, max_seq_len, d_model=128, n_layers=2,
                 d_ff=256, n_heads=4, p_dropout=0.0, device="cpu"):
    del n_heads, p_dropout
    return {
        "in": nn.init_linear(gen, emb_dim, d_model, device),
        "pos": 0.02 * torch.randn((max_seq_len + 1, d_model), generator=gen,
                                  device=device),
        "blocks": [_init_block(gen, d_model, d_ff, device)
                   for _ in range(n_layers)],
        "ln_f": nn.init_layer_norm(d_model, device),
        "mu": nn.init_linear(gen, d_model, z_dim, device),
        "logvar": nn.init_linear(gen, d_model, z_dim, device),
    }


def _blocks(blocks, x, mask, n_heads, p_dropout, train, gen, keeps, tp,
            blocks_apply):
    """The block stack: ``blocks_apply(blocks, x, mask)`` when given (the
    pipeline's schedule, which carries no dropout), else each block in
    turn."""
    if blocks_apply is not None:
        return blocks_apply(blocks, x, mask)
    for i, p in enumerate(blocks):
        x = _block_full(p, x, mask, n_heads, p_dropout, train, gen,
                        None if keeps is None else keeps[i], tp)
    return x


def apply_encoder(params, emb, pad_mask, n_heads=4, p_dropout=0.0,
                  train=False, bf16=False, gen=None, keeps=None, tp=None,
                  blocks_apply=None):
    """emb [B, T, E], pad_mask [B, T] (True at real tokens) -> (mu, logvar);
    pooling is the masked mean over the real tokens. ``keeps`` holds one
    dropout mask per block; ``tp`` and ``blocks_apply`` as in the module's
    docstring."""
    T = emb.shape[1]
    dt = _enc_compute_dtype(params, bf16)
    blocks = nn.cast_tree(params["blocks"], dt)
    x = (nn.linear(params["in"], emb) + params["pos"][:T]).to(dt)
    mask = pad_mask[:, None, None, :]
    x = _blocks(blocks, x, mask, n_heads, p_dropout, train, gen, keeps, tp,
                blocks_apply)
    x = nn.layer_norm(params["ln_f"], x).float()
    denom = torch.clamp(pad_mask.sum(1, keepdim=True), min=1).to(x.dtype)
    pooled = (x * pad_mask[:, :, None]).sum(1) / denom
    return (nn.linear(params["mu"], pooled),
            nn.linear(params["logvar"], pooled))


# ---- decoder: (z, c) + tokens -> logits ---------------------------------------

def init_decoder(gen, emb_dim, z_dim, c_dim, output_dim, max_seq_len,
                 d_model=128, n_layers=2, d_ff=256, n_heads=4, p_dropout=0.0,
                 device="cpu"):
    del n_heads, p_dropout
    return {
        "in": nn.init_linear(gen, emb_dim, d_model, device),
        "latent": nn.init_linear(gen, z_dim + c_dim, d_model, device),
        "pos": 0.02 * torch.randn((max_seq_len + 1, d_model), generator=gen,
                                  device=device),
        "blocks": [_init_block(gen, d_model, d_ff, device)
                   for _ in range(n_layers)],
        "ln_f": nn.init_layer_norm(d_model, device),
        "out": nn.init_linear(gen, d_model, output_dim, device),
    }


def apply_teacher_forced(params, emb_params, tokens, z, c, train, n_heads=4,
                         p_word_dropout=0.3, p_dropout=0.0, bf16=False,
                         gen=None, word_drop=None, keeps=None, tp=None,
                         blocks_apply=None):
    """tokens [B, T] -> logits [B, T, V], logits[t] = f(latent,
    tokens[0..t]): one causal pass over [latent, emb(tokens)] (length T+1)
    whose outputs at positions 1..T are the per-step logits.
    ``word_drop`` [B, T] and ``keeps`` (one mask per block) are the
    dropout masks; those not given are drawn from ``gen``. ``tp`` and
    ``blocks_apply`` as in the module's docstring."""
    x_tok = nn.word_dropout(tokens, p_word_dropout, UNK_IDX, train, gen,
                            word_drop)
    emb = nn.embed(emb_params, x_tok)                      # [B, T, E]
    T = emb.shape[1]
    dt = compute_dtype(params, bf16)
    blocks = nn.cast_tree(params["blocks"], dt)
    tok_in = nn.linear(params["in"], emb)                  # [B, T, D]
    lat = nn.linear(params["latent"], torch.cat([z, c], dim=1))[:, None, :]
    x = (torch.cat([lat, tok_in.to(lat.dtype)], dim=1)
         + params["pos"][:T + 1]).to(dt)
    S = T + 1
    ar = torch.arange(S, device=x.device)
    mask = (ar[None, :] <= ar[:, None])[None, None, :, :]
    x = _blocks(blocks, x, mask, n_heads, p_dropout, train, gen, keeps, tp,
                blocks_apply)
    x = nn.layer_norm(params["ln_f"], x).float()
    return nn.linear(params["out"], x[:, 1:])              # [B, T, V]


def init_cache(params, z, c, max_seq_len, n_heads=4, bf16=False):
    """The latent prefix through all layers: the decoder state of the step
    engines, {'k': [L x [B, S, D]], 'v': ..., 'pos': [B]} with
    S = max_seq_len + 1, the prefix at position 0 and pos = 1, the next
    write position."""
    B = z.shape[0]
    D = params["pos"].shape[1]
    S = max_seq_len + 1
    dt = compute_dtype(params, bf16)
    blocks = nn.cast_tree(params["blocks"], dt)
    x = _entry(nn.linear(params["latent"], torch.cat([z, c], dim=1).to(dt)),
               params["pos"][0], dt)
    pos0 = torch.zeros((B,), dtype=torch.int32, device=z.device)
    ks, vs = [], []
    for p in blocks:
        empty = torch.zeros((B, S, D), dtype=dt, device=z.device)
        x, k_l, v_l = _block_step(p, x, empty, empty, pos0, n_heads, 0)
        ks.append(k_l)
        vs.append(v_l)
    return {"k": ks, "v": vs,
            "pos": torch.ones((B,), dtype=torch.int32, device=z.device)}


def apply_step(params, emb_params, token_hard, token_soft, cache, n_heads=4,
               bf16=False, write_pos=None):
    """One free-running step with the KV cache; token_soft ([B, V]
    probabilities) takes precedence over token_hard ([B] indices).
    ``write_pos``, the cache's (uniform) position as an int, spares each
    block a device sync when the caller knows it. Returns (logits [B, V]
    f32, new cache). The given cache is not modified, so autograd can run
    through the steps."""
    if token_soft is not None:
        emb = nn.soft_embed(emb_params, token_soft)
    else:
        emb = nn.embed(emb_params, token_hard)
    pos = cache["pos"]
    dt = compute_dtype(params, bf16)
    blocks = nn.cast_tree(params["blocks"], dt)
    x = _entry(nn.linear(params["in"], emb), params["pos"][pos.long()], dt)
    ks, vs = list(cache["k"]), list(cache["v"])
    for li, p in enumerate(blocks):
        x, ks[li], vs[li] = _block_step(p, x, ks[li], vs[li], pos, n_heads,
                                        write_pos)
    return (nn.linear(params["out"], final_ln(params["ln_f"], x, dt)),
            {"k": ks, "v": vs, "pos": pos + 1})
