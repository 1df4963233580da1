"""Pipeline parallelism for the transformer family (GPipe): the
counterpart of the JAX package's ``parallel/pp.py``.

The block stack of each transformer leg is split into S = ``pipe.world``
contiguous stages: stage s (the rank's place on the 'pipe' axis of
``dist.Mesh``) holds blocks [s L / S, (s + 1) L / S) alone, and the rest
of the tree is replicated. ``make_blocks_apply`` returns the schedule
that the encoder's and the teacher-forced decoder's full-sequence passes
run in the blocks' place (``models/transformer.py``'s ``blocks_apply``):

* the batch is cut into M = gcd(B, n_micro or S) microbatches, which
  stream through the stages in M + S - 1 ticks; at tick t stage s runs
  microbatch t - s (clamped: an out-of-range tick computes on data whose
  result is never kept, and whose gradient is 0) and hands its output to
  stage s + 1 (``collectives.Shard.ring_shift``, the JAX package's
  ppermute ring);
* every rank runs the same operations at every tick, only the data
  differ (stage 0 reads its microbatch, the others what they received),
  so the ranks' autograd graphs have one shape and their backward calls
  the collectives in one order;
* the entry is ``Shard.enter``: only stage 0 reads the input, so the sum
  of the ranks' input gradients is the gradient every rank's replicated
  embedding needs (JAX gets it from the transpose of shard_map's
  replicated in_spec);
* the exit is ``Shard.leave`` of the last stage's outputs and zeros
  elsewhere (the psum of l. 143-152 there): every rank gets them, and the
  identity backward hands the last stage the loss's gradient once, not
  S times.

The backward needs no schedule of its own: autograd runs the ticks back,
each hand-off's gradient going back one stage. Microbatches are
concatenated, not reduced, so a step is the one-device step up to the
order of the blocks' gradient sums over the microbatches. The cached
decode step (phase 2's samplers) reads the blocks gathered in full
(``dist.Mesh.gather``): a one-token step is too small to ship between
stages, as the JAX package keeps generation one program.

Constraints, raised as the JAX package asserts them: n_layers % S == 0
and p_dropout == 0 (a block's dropout mask would have to travel with its
microbatch).
"""

import contextlib
import dataclasses
import math

import torch

from ..models.transformer import _block_full
from ..train.checkpoints import flatten, unflatten


def make_blocks_apply(pipe, n_heads, n_micro=None, tp=None):
    """``blocks_apply(blocks, x, mask) -> x``, the GPipe schedule over the
    pipe group ``pipe`` (a ``collectives.Shard``); ``blocks`` is this
    stage's list, x [B, S_len, D], mask broadcastable to [B, H, S_len,
    S_len]. ``tp``, the model group, shards each block as well (the 3D
    mesh)."""
    S, idx = pipe.world, pipe.rank
    # stage 0 reads the input, the last stage's outputs leave: Python
    # weights (1 or 0), so every rank builds the same graph and a capture
    # makes no host-to-device copy
    first, last = float(idx == 0), float(idx == S - 1)

    def blocks_apply(blocks, x, mask):
        B = x.shape[0]
        M = math.gcd(B, int(n_micro) if n_micro else S)
        x = pipe.enter(x)
        xm = x.reshape(M, B // M, *x.shape[1:])
        mask_b = mask.expand((B,) + tuple(mask.shape[1:]))
        maskm = mask_b.reshape(M, B // M, *mask_b.shape[1:])
        recv = torch.zeros_like(xm[0])
        outs = []
        for t in range(M + S - 1):
            m_in = min(max(t - idx, 0), M - 1)
            y = xm[m_in] * first + recv * (1.0 - first)
            for p in blocks:
                y = _block_full(p, y, maskm[m_in], n_heads, tp=tp)
            if t >= S - 1:
                outs.append(y)
            if t < M + S - 2:
                recv = pipe.ring_shift(y)
        out = torch.cat(outs).reshape(x.shape)
        return pipe.leave(out * last)

    return blocks_apply


def validate_pp_divisibility(model, pp):
    """Every transformer leg's depth must split into the stages, and its
    dropout be off (``parallel/pp.py:165-177`` there)."""
    for name, args in (("encoder", model.enc_tfm_args),
                       ("decoder", model.dec_tfm_args)):
        if not args:
            continue
        n_layers = args.get("n_layers", 2)
        if n_layers % pp:
            raise ValueError(f"{name} n_layers {n_layers} not divisible by "
                             f"pipe={pp}")
        if args.get("p_dropout", 0.0) != 0.0:
            raise ValueError(f"pipeline parallelism requires {name} "
                             f"p_dropout == 0")


def make_pp_model(model, pipe, n_micro=None, tp=None):
    """``model`` with the block stacks of its transformer legs run by the
    GPipe schedule over ``pipe`` (and sharded over ``tp`` too)."""
    validate_pp_divisibility(model, pipe.world)
    upd = {}
    if model.E_class == "transformer":
        upd["enc_blocks_apply"] = make_blocks_apply(
            pipe, model.enc_tfm_args.get("n_heads", 4), n_micro, tp)
    if model.G_class == "transformer":
        upd["dec_blocks_apply"] = make_blocks_apply(
            pipe, model.dec_tfm_args.get("n_heads", 4), n_micro, tp)
    if not upd:
        raise ValueError("pipeline parallelism applies to the transformer "
                         "family")
    return dataclasses.replace(model, **upd)


def _blocks_at(path):
    """(the path up to its 'blocks' list, the block's index), or None."""
    if "blocks" not in path:
        return None
    i = path.index("blocks")
    return path[:i + 1], path[i + 1]


def shard_tree(tree, shard):
    """This stage's blocks of a full tree (and every other leaf; copies),
    its blocks re-indexed from 0; the tree itself without a pipe axis."""
    if shard is None:
        return tree
    flat = flatten(tree)
    n_layers = {}
    for path in flat:
        at = _blocks_at(path)
        if at is not None:
            n_layers[at[0]] = max(n_layers.get(at[0], 0), at[1] + 1)
    out = {}
    for path, leaf in flat.items():
        at = _blocks_at(path)
        if at is not None:
            per = n_layers[at[0]] // shard.world
            if at[1] // per != shard.rank:
                continue
            path = at[0] + (at[1] - shard.rank * per,) + path[len(at[0]) + 1:]
        out[path] = leaf.detach().clone()
    return unflatten(out)


def gather_tree(tree, shard, grad=False):
    """The full tree from the stages' blocks: one all-gather of the
    stage's blocks packed flat. ``grad`` as ``dist.Mesh.gather``."""
    if shard is None:
        return tree
    flat = flatten(tree)
    own = [p for p in flat if _blocks_at(p) is not None]
    if not own:
        return tree
    per = {}
    for p in own:
        prefix, b = _blocks_at(p)
        per[prefix] = max(per.get(prefix, 0), b + 1)
    with contextlib.nullcontext() if grad else torch.no_grad():
        sizes = [flat[p].numel() for p in own]
        vec = torch.cat([flat[p].reshape(-1) for p in own])
        stages = (shard.gather_own(vec) if grad
                  else shard.all_gather_flat(vec)).view(shard.world, -1)
        out = {p: (v if grad else v.detach().clone())
               for p, v in flat.items() if p not in own}
        for s in range(shard.world):
            at = 0
            for p, n in zip(own, sizes):
                prefix, b = _blocks_at(p)
                out[prefix + (s * per[prefix] + b,) + p[len(prefix) + 1:]] = \
                    stages[s, at:at + n].view(flat[p].shape)
                at += n
    return unflatten(out)
