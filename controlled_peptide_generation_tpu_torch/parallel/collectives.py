"""The collectives of a data-parallel step, and the rules that make it the
one-device step on the global batch (the JAX package's DP step is that
step with the gradient psum inserted by XLA, ``parallel/mesh.py:69`` there).
The JAX package's ``make_dp_train_step``, ``make_dp_train_scan``,
``make_zero_train_step``, ``make_dp_full_step`` and ``make_dp_full_scan``
are the port's ``make_train_step``, ``make_train_chunk``, ``FullStep`` and
``FullChunk`` given a ``Shard`` (and ``zero=True``).

Every rank reads the same global batch and draws the same global draws
(the generators are keyed by (seed, stream, it)); a ``Shard`` keeps rank
r's rows [r b, (r + 1) b) of each. Its loss is the one-device loss of
those rows, whose per-row means are means over its b rows, and the
gradients are averaged over the ranks (``mean_``, one collective over one
flat buffer): the mean of the ranks' means is the global mean. Four
places couple the rows and need more:

* the reconstruction loss divides by the token count of the global batch
  (``losses.recon_dec``'s ``count``: every rank holds the global batch, so
  no collective is needed for it), over the world size, as the gradients
  are averaged;
* the WAE-MMD terms act on z gathered from all ranks (``gather``). Every
  rank computes the same global term, so the gather's backward keeps the
  rank's own rows of its own gradient, times the world size (the average
  over ranks divides it back). ``torch.distributed.nn``'s all_gather
  sums the ranks' incoming gradients instead, one more collective for the
  same numbers here; under a sum of the ranks' gradients it would count
  the term world times;
* the deconv decoder's batch norm takes its statistics over the global
  batch (``sum``, an all-reduce whose backward is an all-reduce), while a
  shard is ``active``; outside a DP step, and without a group, they stay
  local;
* the optimizers clip by the global norm, after the gradients are
  averaged (``train/opt.py``; ZeRO-1's sums the shards' squares,
  ``parallel/zero.py``), and the logged metrics are averaged
  (``mean_metrics``).

Tensor and pipeline parallelism (``parallel/tp.py``, ``parallel/pp.py``)
use a ``Shard`` of the model or pipe group with four more operators:
Megatron's ``enter`` and ``leave``, the stage hand-off ``ring_shift`` and
``gather_own``, each keeping a replicated gradient counted once.

Under NCCL the average is ``ReduceOp.AVG``, which NCCL runs as a sum
pre-multiplied by 1 / world: at world 1 that is one kernel of its own,
where NCCL drops an in-place sum of one rank altogether, so a world-1
capture holds the collective it holds at any world. Gloo averages too.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

# the shard of the DP step being traced in this thread (``active``)
_ACTIVE = contextvars.ContextVar("dp_shard", default=None)


def _all_gather(out, x, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter(out, x, op, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, op=op, group=group)


class Shard:
    """Rank ``rank`` of ``world`` in ``group`` (the default group when
    None) in a data-parallel step: it holds rows [rank b, (rank + 1) b) of
    every global batch of b world rows."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))

    def __repr__(self):
        return (f"Shard(rank {self.rank} of {self.world}, "
                f"{self.backend})")

    def rows(self, x, dim=0):
        """This rank's rows of a global tensor along ``dim`` (of each
        tensor of a list), a view."""
        if isinstance(x, (list, tuple)):
            return [self.rows(t, dim) for t in x]
        n = x.shape[dim]
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over {self.world} "
                             f"ranks")
        b = n // self.world
        return x.narrow(dim, self.rank * b, b)

    def rows_of(self, draws, dims):
        """``draws`` with this rank's rows of each entry named in
        ``dims`` ({name: row dim}); the others (prior samples, an RF
        basis) stay global."""
        return {k: self.rows(v, dims[k]) if k in dims else v
                for k, v in draws.items()}

    def gather(self, x):
        """x [b, ...] of every rank, in rank order: [b world, ...]. The
        backward keeps this rank's rows of its own gradient times the
        world size (see the module's docstring)."""
        return _GatherRows.apply(x, self)

    def sum(self, x):
        """The sum of x over the ranks; its backward sums the gradients
        over the ranks too."""
        return _AllReduceSum.apply(x, self)

    def mean_(self, flat):
        """Average a flat buffer over the ranks, in place."""
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
        return flat

    def mean_metrics(self, metrics, keep=()):
        """The ranks' average of each 0-d metric, by one collective; the
        names in ``keep`` (already global) pass through."""
        names = sorted(k for k in metrics if k not in keep)
        packed = torch.stack([metrics[k].detach().float() for k in names])
        self.mean_(packed)
        out = dict(zip(names, packed.unbind(0)))
        out.update({k: metrics[k] for k in keep if k in metrics})
        return out

    def all_gather_flat(self, x):
        """[n] of every rank, in rank order: [n world] (no autograd)."""
        out = torch.empty((x.shape[0] * self.world,), dtype=x.dtype,
                          device=x.device)
        _all_gather(out, x.contiguous(), self.group)
        return out

    def reduce_scatter_mean(self, flat):
        """This rank's segment of the ranks' average of ``flat`` ([n
        world] -> [n])."""
        out = torch.empty((flat.shape[0] // self.world,), dtype=flat.dtype,
                          device=flat.device)
        _reduce_scatter(out, flat.contiguous(), dist.ReduceOp.AVG,
                        self.group)
        return out

    def sum_(self, x):
        """Sum a tensor over the ranks, in place (no autograd)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    # ---- model parallelism (``parallel/tp.py``, ``parallel/pp.py``) ----
    # Every rank of a tensor- or pipeline-parallel group computes the same
    # replicated values around its own slice of the work, so these
    # operators keep each gradient counted once.

    def enter(self, x):
        """Megatron's copy into the group: the identity, whose backward
        sums the ranks' gradients (each rank's is its slice's part). It
        goes before a column-parallel product and at the pipeline's
        entry."""
        return _Enter.apply(x, self)

    def leave(self, x):
        """Megatron's reduce from the group: the sum over the ranks, whose
        backward is the identity (every rank holds the whole replicated
        gradient already). It goes after a row-parallel product and at the
        pipeline's exit."""
        return _Leave.apply(x, self)

    def ring_shift(self, x):
        """x of rank (rank - 1) mod world: one stage's activations handed
        to the next (the JAX package's ppermute over the ring). Its
        backward hands each gradient back the other way. One all-gather
        each way, which gloo runs on CUDA tensors as NCCL does, and which
        every rank calls at every tick, so no rank waits on another's
        schedule."""
        return _RingShift.apply(x, self)

    def gather_own(self, flat):
        """[n] of every rank, in rank order: [n world]. Every rank uses the
        whole result in the same replicated computation, so the backward
        keeps this rank's segment of its own gradient (no collective)."""
        return _GatherOwn.apply(flat, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous()
        out = torch.empty((x.shape[0] * shard.world,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather(out, x, shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        return shard.rows(grad) * shard.world, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.shard.group)
        return out, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.shard.group)
        return out, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shifted(x, shard, by):
    """x of rank (rank - by) mod world, by one all-gather."""
    x = x.contiguous()
    out = torch.empty((shard.world,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    _all_gather(out.view(-1), x.view(-1), shard.group)
    return out[(shard.rank - by) % shard.world].clone()


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _shifted(x, shard, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shifted(grad, ctx.shard, -1), None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, shard):
        ctx.shard = shard
        return shard.all_gather_flat(flat)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        n = grad.shape[0] // shard.world
        return grad[shard.rank * n:(shard.rank + 1) * n], None


@contextlib.contextmanager
def active(shard):
    """Make ``shard`` the one the model's batch norm reads
    (``current``) inside the block, in this thread; None keeps them
    local."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current():
    """The shard of the DP step being traced, or None."""
    return _ACTIVE.get()
