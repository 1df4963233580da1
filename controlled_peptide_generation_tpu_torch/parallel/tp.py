"""Tensor parallelism for the transformer family (Megatron): the
counterpart of the JAX package's ``parallel/tp.py``.

The JAX package annotates the parameters with PartitionSpecs and lets
XLA insert the collectives. Here each rank of the 'model' axis
(``dist.Mesh``) holds its slice of every sharded leaf, and the block
(``models/transformer._block_full`` given the model group) runs its
local heads and units between Megatron's two operators
(``collectives.Shard.enter`` and ``leave``). The layout is JAX's
``transformer_param_specs`` (``parallel/tp.py:66-94`` there):

* ``qkv.w [D, 3D]`` and ``ff1.w [D, F]`` are column-parallel, with their
  biases: the fused projection's columns are head-major ([D, H, 3, Dh],
  ``models/transformer.py``), so model rank t owns heads [t H / tp, (t +
  1) H / tp) with their q, k and v, and attention needs no collective;
* ``attn_out.w [D, D]`` and ``ff2.w [F, D]`` are row-parallel: the
  partial products are summed over the group once each (``leave``), and
  the row-parallel bias is added once, after the sum;
* everything else (LayerNorms, embeddings, positions, the heads, the GRU,
  deconv and classifier legs, a flow) is replicated, and every model rank
  computes it alike.

The operator ``enter`` before each column-parallel product sums the
ranks' input gradients in the backward, so a replicated leaf gets the same
full gradient on every model rank and a sharded leaf its own slice's.
The step is the one-device step on the same inputs up to the order of
the sums (the JAX contract, ``parallel/tp.py:143-149`` there); Adam's
moments live with their slices (``_opt_state_specs`` there) and the
clip's global norm sums a sharded leaf's squares over the group
(``dist.Mesh.global_norm``).

The JAX package's ``make_tp_train_step`` and ``make_tp_full_step`` are
the port's ``train_vae.make_train_step`` and ``train_full.FullStep``
given a ``dist.Mesh`` (``mesh.wrap(model)``, ``mesh.shard(params)``), as
its DP steps are those given a ``Shard``; ``init_state``'s sharding is
``Mesh.shard`` and ``shard_opt``, and ``Mesh.gather`` the way back.

The cached decode step (phase 2's soft and hard samplers) does not run
sharded: it reads the decoder's blocks gathered in full
(``dist.Mesh.gather(..., grad=True)``), every rank repeating it, as the
JAX package keeps generation one program.
"""

import contextlib
import dataclasses

import torch

from ..train.checkpoints import flatten, unflatten

# the Megatron pairs inside a block: column-parallel weights (and biases),
# row-parallel weights
_COL = ("qkv", "ff1")
_ROW = ("attn_out", "ff2")


def split_dim(path):
    """The dim of the leaf at ``path`` (a parameter path, e.g. ('dec',
    'blocks', 0, 'qkv', 'w')) that the 'model' axis splits, or None for a
    replicated leaf."""
    if "blocks" not in path or len(path) < 2:
        return None
    name, leaf = path[-2], path[-1]
    if name in _COL:
        return 1 if leaf == "w" else 0
    if name in _ROW and leaf == "w":
        return 0
    return None


def param_specs(params):
    """The JAX package's ``transformer_param_specs`` as a tree like
    ``params``: each leaf the tuple of its PartitionSpec (an axis name or
    None a dim; () replicated)."""
    out = {}
    for path, leaf in flatten(params).items():
        d = split_dim(path)
        if d is None:
            out[path] = ()
        else:
            out[path] = tuple("model" if i == d else None
                              for i in range(leaf.dim()))
    return unflatten(out)


def validate_tp_divisibility(model, tp):
    """Head count and FF width must divide over the model axis (the JAX
    package asserts the same, ``parallel/tp.py:129-137`` there)."""
    for args in (model.enc_tfm_args, model.dec_tfm_args):
        if not args:
            continue
        if args.get("n_heads", 4) % tp:
            raise ValueError(f"n_heads {args.get('n_heads', 4)} not "
                             f"divisible by tp={tp}")
        if args.get("d_ff", 256) % tp:
            raise ValueError(f"d_ff {args.get('d_ff', 256)} not divisible "
                             f"by tp={tp}")


def make_tp_model(model, shard):
    """``model`` whose transformer blocks run model rank ``shard.rank``'s
    heads and units (the model group's ``collectives.Shard``)."""
    validate_tp_divisibility(model, shard.world)
    return dataclasses.replace(model, tp=shard)


def shard_tree(tree, shard):
    """This model rank's slices of a full tree (copies); the tree itself
    without a model axis."""
    if shard is None:
        return tree
    out = {}
    for path, leaf in flatten(tree).items():
        d = split_dim(path)
        if d is not None:
            leaf = leaf.chunk(shard.world, d)[shard.rank]
        out[path] = leaf.detach().clone()
    return unflatten(out)


def gather_tree(tree, shard, grad=False):
    """The full tree from the model ranks' slices: one all-gather of the
    sharded leaves packed flat. ``grad`` as ``dist.Mesh.gather``."""
    if shard is None:
        return tree
    flat = flatten(tree)
    split = [p for p in flat if split_dim(p) is not None]
    if not split:
        return tree
    with contextlib.nullcontext() if grad else torch.no_grad():
        sizes = [flat[p].numel() for p in split]
        vec = torch.cat([flat[p].reshape(-1) for p in split])
        ranks = (shard.gather_own(vec) if grad
                 else shard.all_gather_flat(vec)).view(shard.world, -1)
        out = {p: (v if grad else v.detach().clone())
               for p, v in flat.items()}
        at = 0
        for p, n in zip(split, sizes):
            out[p] = torch.cat([ranks[r, at:at + n].view(flat[p].shape)
                                for r in range(shard.world)],
                               dim=split_dim(p))
            at += n
    return unflatten(out)
