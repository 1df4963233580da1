"""Batched beam search over the GRU and transformer decoders, and over
the deconv decoder's precomputed logits (``beam_search_logits``).

All (batch, beam) lanes advance together: one whole-scan kernel per
family runs the steps (ops/beam_kernel.py for the GRU, ops/
tfm_beam_kernel.py for the transformer), as a CUDA kernel on CUDA tensors
or as its plain torch version on CPU tensors; finished hypotheses are then
rebuilt from the per-step tapes and walked back to token rows here.

The route follows the device alone. In the JAX package the transformer's
whole-scan kernel runs only under ``--hw.pallas_beam on``
(``ops/beam.py:212-221`` there); in the port a CUDA tensor always takes
the kernel (and raises outside its scope), a CPU tensor the plain
version. A shape outside the kernel's scope (``in_kernel_scope``; beam
15 at T 25) runs the plain version only where the caller asks for it
with plain=True, as ``generation.generate_sentences`` does after deciding
the route, where the JAX package runs its XLA arm. Both kernels run
float32 and bfloat16 (``--hw.gen_dtype bfloat16``, and the transformer's
``T_args.bf16``).

Semantics, as in the JAX package's ops/beam.py:

* log-softmax scores accumulate additively in fp32; START is always
  blocked and EOS blocked below min_length, at -1e20;
* rows whose last token is EOS get their children blocked at -1e20;
* the first advance draws only from beam 0's distribution;
* a hypothesis is finished when its token is EOS, recorded in step-major,
  beam-minor order;
* a sentence is done when EOS tops the beam and >= n_best finished; done
  sentences emit PAD and stop advancing;
* finalization pads with current beams until n_best, stable-sorts by
  score descending and walks backpointers, including the BOS row.
"""

import torch

from ..data.vocab import PAD_IDX, START_IDX, EOS_IDX
from ..models import decoder
from ..models import transformer as tfm
from . import beam_kernel, nn, tfm_beam_kernel


def _backtrace(t, k, ys, ptrs, T):
    """Walk backpointers from (t, k) [B, N]; ys [B, T+1, K], ptrs
    [B, T, K] -> [B, N, T+1] tokens, PAD beyond t."""
    toks = [None] * T
    k_cur = k
    for j in range(T - 1, -1, -1):
        on = (j + 1) <= t
        tok = torch.gather(ys[:, j + 1, :], 1, k_cur)
        toks[j] = torch.where(on, tok, PAD_IDX)
        k_cur = torch.where(on, torch.gather(ptrs[:, j, :], 1, k_cur), k_cur)
    first = torch.gather(ys[:, 0, :], 1, k_cur)
    return torch.stack([first] + toks, dim=2)


def _finalize(ys, ptrs, scores, adv, fin_cnt, fin_mask, fin_score, *, K,
              n_best, T):
    """sort_finished(minimum=n_best) + n_best backtraces for a batch.

    fin_mask/fin_score [B, T*K] are the per-step finish emissions
    flattened step-major (the heap's insertion order); the
    pad-with-current-beams entries follow all finish slots."""
    B = ys.shape[0]
    dev = ys.device
    i = torch.arange(n_best, device=dev)
    n_add = torch.clamp(n_best - fin_cnt.long(), min=0)
    flat = torch.arange(T * K, device=dev)
    pad_sc = scores[:, torch.clamp(i, max=K - 1)]
    keyed = torch.cat([
        torch.where(fin_mask, fin_score, float("-inf")),
        torch.where(i[None, :] < n_add[:, None], pad_sc, float("-inf")),
    ], dim=1)
    t_all = torch.cat([(flat // K + 1).expand(B, -1),
                       adv.long()[:, None].expand(B, n_best)], dim=1)
    k_all = torch.cat([(flat % K).expand(B, -1),
                       i.expand(B, n_best)], dim=1)
    order = torch.argsort(-keyed, dim=1, stable=True)[:, :n_best]
    ts = torch.gather(t_all, 1, order)
    ks = torch.gather(k_all, 1, order)
    sc = torch.gather(keyed, 1, order)
    return _backtrace(ts, ks, ys, ptrs, T), sc


def beam_search(model, params, z, c, beam_size=5, n_best=3, min_length=1,
                max_len=None, plain=False):
    """z [B, z_dim], c [B, c_dim] -> (hyps [B, n_best, T+1] int64,
    scores [B, n_best] f32). hyps[:, :, 0] is the BOS row token.

    The steps run in the family's whole-scan kernel (beam_scan_gru or
    beam_scan_tfm): the CUDA kernel on CUDA tensors (raising where its
    scope does not cover the model), its plain version on CPU tensors.
    plain=True runs the plain version on any device: where the shape is
    outside the kernel's scope (``in_kernel_scope``), as the JAX package
    runs such shapes in its XLA arm, and to hold the kernel against it.
    ``beam_search.plain_runs`` counts the calls with plain=True."""
    if plain:
        beam_search.plain_runs += 1
    if beam_size < n_best:
        raise ValueError("can't return more hypotheses than the beam holds")
    K = beam_size
    T = max_len if max_len is not None else model.max_seq_len
    if T > model.max_seq_len:
        raise ValueError(f"max_len {T} exceeds model.max_seq_len "
                         f"{model.max_seq_len}")
    if model.G_class == "transformer":
        tapes = _scan_tfm(model, params, z, c, K, T, n_best, min_length,
                          plain)
    else:
        tapes = _scan_gru(model, params, z, c, K, T, n_best, min_length,
                          plain)
    return hyps_from_tapes(tapes, n_best)


beam_search.plain_runs = 0


def beam_search_logits(all_logits, beam_size=5, n_best=3, min_length=1):
    """The beam over precomputed logits [B, T, V] (the deconv family's
    replay, the JAX package's ``beam_search_logits``): every beam of a
    sentence sees the same log-softmax at step t, there is no decoder
    state, and the bookkeeping is the GRU beam's plain version's
    (``beam_kernel.scan_step``). Returns (hyps [B, n_best, T+1], scores
    [B, n_best]). It is no kernel's plain version: its calls count in
    ``beam_search_logits.runs``, not in ``beam_search.plain_runs``."""
    if beam_size < n_best:
        raise ValueError("can't return more hypotheses than the beam holds")
    beam_search_logits.runs += 1
    B, T, V = all_logits.shape
    K = beam_size
    state = beam_kernel.scan_init(B, K, all_logits.device)
    tapes = []
    for t in range(T):
        logp = torch.log_softmax(all_logits[:, t].float(), dim=-1)
        state, tape, _ = beam_kernel.scan_step(
            logp[:, None, :].expand(B, K, V), state, K=K, V=V,
            min_length=min_length, n_best=n_best)
        tapes.append(tape)
    return hyps_from_tapes(beam_kernel.scan_tapes(state, tapes), n_best)


beam_search_logits.runs = 0


def in_kernel_scope(model, params, z, beam_size):
    """True where the family's beam kernel covers this model, beam width
    and type (``beam_kernel.applicable`` / ``tfm_beam_kernel.applicable``,
    the JAX kernels' scope). Outside it the JAX package decodes in its XLA
    arm; here the caller passes plain=True."""
    if model.G_class == "transformer":
        dt = tfm.compute_dtype(params["dec"],
                               model.dec_tfm_args.get("bf16", False))
        return tfm_beam_kernel.applicable(model, beam_size, dt)
    return beam_kernel.applicable(model, beam_size, z.dtype)


def _check_scope(model, params, z, K):
    if z.device.type == "cuda" and not in_kernel_scope(model, params, z, K):
        raise ValueError("the CUDA beam kernel's scope does not cover this "
                         "model/beam/dtype (ops/beam_kernel.py and "
                         "ops/tfm_beam_kernel.py applicable); pass "
                         "plain=True for the plain version")


def _scan_gru(model, params, z, c, K, T, n_best, min_length, plain):
    if not plain:
        _check_scope(model, params, z, K)
    inputs, dims = decode_inputs(model, params, z, c)
    if plain or "skip" in dims:
        # a skip model reaches here unasked only on CPU tensors
        scan = beam_kernel.beam_scan_gru_reference
    else:
        scan = beam_kernel.beam_scan_gru
    return scan(*inputs, T=T, K=K, V=model.n_vocab, min_length=min_length,
                n_best=n_best, **dims)


def _scan_tfm(model, params, z, c, K, T, n_best, min_length, plain):
    if plain:
        scan = tfm_beam_kernel.beam_scan_tfm_reference
    else:
        scan = tfm_beam_kernel.beam_scan_tfm
        _check_scope(model, params, z, K)
    inputs, dims = tfm_scan_inputs(model, params, z, c)
    return scan(*inputs, T=T, K=K, V=model.n_vocab, min_length=min_length,
                n_best=n_best, **dims)


_TFM_PRODUCTS = ("qkv", "attn_out", "ff1", "ff2")


def tfm_scan_inputs(model, params, z, c):
    """The transformer decoder folded for beam_scan_tfm, as the JAX
    package's ``_beam_search_pallas_tfm`` builds its kernel's inputs: the
    token table emb (PAD row zeroed) @ in.w + in.b, the position table, the
    blocks in the compute type, the final LN and head, and the position-0
    rows of init_cache. Returns (inputs, {"S", "H", "F"})."""
    t_args = model.dec_tfm_args
    dec = params["dec"]
    dt = tfm.compute_dtype(dec, t_args.get("bf16", False))
    S = model.max_seq_len + 1
    tok_table = nn.canonical_zeros(nn.linear(
        dec["in"], nn.embedding_table(params["emb"])).to(dt))
    cache0 = model.init_decoder_hidden(params, z, c)
    # the products' weights and biases in the compute type; LayerNorm keeps
    # the tree's parameters (f32 math), as the JAX kernel takes them
    layers = [{k: nn.cast_tree(v, dt) if k in _TFM_PRODUCTS else v
               for k, v in blk.items()} for blk in dec["blocks"]]
    inputs = (tok_table, dec["pos"][:S].to(dt), layers, dec["ln_f"]["g"],
              dec["ln_f"]["b"], dec["out"]["w"], dec["out"]["b"],
              [kl[:, 0, :] for kl in cache0["k"]],
              [vl[:, 0, :] for vl in cache0["v"]])
    return inputs, {"S": S, "H": t_args.get("n_heads", 4),
                    "F": t_args.get("d_ff", 4 * t_args.get("d_model", 128))}


def decode_inputs(model, params, z, c):
    """The beam kernel's inputs of ``model``'s family for latents z, c cast
    to the weight tree's type, as the round casts them (GRU: the step
    tables, the recurrent and head weights and the initial hidden state,
    the inputs of ``beam_kernel.beam_scan_gru``; transformer:
    ``tfm_scan_inputs``), and their dims ({"H"}, with skip connections
    also "skip", the skip maps of ``beam_scan_gru_reference``; or {"S",
    "H", "F"})."""
    wdt = params["dec"]["out"]["w"].dtype
    z, c = z.to(wdt), c.to(wdt)
    if model.G_class == "transformer":
        return tfm_scan_inputs(model, params, z, c)
    tok, zc_gi = decoder.step_tables(params["dec"], params["emb"], z, c)
    d = params["dec"]
    dims = {"H": model.h_dec}
    if model.skip_connections:
        dims["skip"] = (d["skip_x"], d["skip_z"])
    return (tok, zc_gi, d["gru"]["wh"], d["gru"]["bh"], d["out"]["w"],
            d["out"]["b"], model.init_decoder_hidden(params, z, c)), dims


def hyps_from_tapes(tapes, n_best):
    """The scan's (ys, ptr, sc [B, T, K], scores [B, K], adv [B], fin [B])
    -> (hyps [B, n_best, T+1], scores [B, n_best])."""
    ys_steps, ptr_steps, sc_steps, scores_f, adv_f, fin_f = tapes
    B, T, K = ys_steps.shape
    # done sentences emit PAD, never EOS, so this is the finish mask
    fin_mask = (ys_steps == EOS_IDX).reshape(B, T * K)
    prev0 = torch.full((B, 1, K), PAD_IDX, dtype=torch.long,
                       device=ys_steps.device)
    prev0[:, :, 0] = START_IDX
    ys = torch.cat([prev0, ys_steps.long()], dim=1)        # [B, T+1, K]
    return _finalize(ys, ptr_steps.long(), scores_f, adv_f, fin_f,
                     fin_mask, sc_steps.reshape(B, T * K), K=K,
                     n_best=n_best, T=T)
