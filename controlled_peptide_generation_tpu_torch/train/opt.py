"""The phase-1 optimizers: clip by global norm, then Adam, with optax's
formulas, per leaf (the JAX package's ``optax.chain(clip_by_global_norm(c),
adam(lr))``) or on one raveled vector (its ``flat_adam``, under
``--hw.flat_optimizer on``).

* clip: with n the global norm over all leaves, g stays g when n < c and
  becomes (g / n) * c otherwise (``torch.nn.utils.clip_grad_norm_``
  scales by c / (n + 1e-6) instead, so it is not used); the flat variant
  scales by g * (c / n), as ``flat_adam`` does;
* Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
  update = -lr * mu_hat / (sqrt(nu_hat) + eps) with the bias corrections
  1 - b^count computed in float32 from the count on the device.

``ClipAdam``'s state is ``{"count", "mu", "nu"}`` with mu and nu nested
like the parameters; ``FlatAdam``'s is ``{"m", "v", "count"}`` with m and
v one vector over the leaves in the JAX package's ravel order
(``checkpoints.ravel_order``). ``train/checkpoints.py`` maps both to the JAX package's
key paths. Parameters are updated in place (the trainer owns them, and a
captured CUDA graph of the step holds their addresses); a step makes no
host-to-device copy, so it can be captured.

Under data parallelism ``reduce`` (``collectives.Shard.mean_``) averages
the gradients over the ranks before the clip, in one collective over one
flat buffer: the flat Adam's own vector, or the per-leaf Adam's leaves
coalesced into one; the clip's norm is then the global one. ZeRO-1's
sharded Adam is ``parallel/zero.py``. Under tensor or pipeline
parallelism the per-leaf Adam steps the rank's slices and stage blocks
(its moments live with them), and ``norm`` (``dist.Mesh.global_norm``)
sums the squares of a leaf split over ranks across them.
"""

import torch

from .checkpoints import flatten, ravel_order


def _zeros(tree):
    """Zeros nested like ``tree`` (dicts, and lists such as the
    transformer's blocks)."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


def _device(params):
    return next(iter(flatten(params).values())).device


def _bias_corrections(count, b1, b2):
    """(1 - b1^count, 1 - b2^count) in float32, from the device count:
    a Python float base, so no host tensor is copied to the device."""
    c32 = count.to(torch.float32)
    return 1.0 - torch.pow(b1, c32), 1.0 - torch.pow(b2, c32)


def _reduced(g_flat, reduce):
    """The leaves' gradients averaged over the ranks by ``reduce`` on one
    coalesced buffer, as views of it."""
    leaves = list(g_flat.values())
    buf = reduce(torch.cat([g.reshape(-1) for g in leaves]))
    return dict(zip(g_flat, (v.view_as(g) for v, g in zip(
        buf.split([g.numel() for g in leaves]), leaves))))


class ClipAdam:
    def __init__(self, lr, clip, b1=0.9, b2=0.999, eps=1e-8, reduce=None,
                 norm=None):
        self.lr, self.clip = float(lr), float(clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.reduce = reduce
        self.norm = norm or self.global_norm

    def init(self, params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=_device(params)),
                "mu": _zeros(params), "nu": _zeros(params)}

    @staticmethod
    def global_norm(grads):
        """The global norm of a gradient tree (or of {path: leaf})."""
        return torch.sqrt(sum((g * g).sum() for g in flatten(grads).values()))

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` and ``state`` in place from ``grads`` (nested
        like params). Returns the global norm of the unclipped grads."""
        p_flat, g_flat = flatten(params), flatten(grads)
        if self.reduce is not None:
            g_flat = _reduced(g_flat, self.reduce)
        mu, nu = flatten(state["mu"]), flatten(state["nu"])
        norm = self.norm(g_flat)
        keep = norm < self.clip
        state["count"].add_(1)
        bc1, bc2 = _bias_corrections(state["count"], self.b1, self.b2)
        for path, p in p_flat.items():
            g = g_flat[path]
            g = torch.where(keep, g, (g / norm) * self.clip)
            m = mu[path]
            v = nu[path]
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(-self.lr * upd)
        return norm


class FlatAdam:
    """``flat_adam`` of the JAX package: clip and Adam on the gradients
    raveled into one vector (``ravel_order``), so a step is a fixed
    handful of launches however many leaves the model has (the
    transformer's 67 would take several launches each per leaf)."""

    def __init__(self, lr, clip, b1=0.9, b2=0.999, eps=1e-8, reduce=None):
        self.lr, self.clip = float(lr), float(clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.reduce = reduce

    def init(self, params):
        flat = flatten(params)
        n = sum(leaf.numel() for leaf in flat.values())
        dev = _device(params)
        # m and v are distinct buffers: the step writes both in place
        return {"m": torch.zeros((n,), device=dev),
                "v": torch.zeros((n,), device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` and ``state`` in place from ``grads`` (nested
        like params). Returns the global norm of the unclipped grads."""
        order = ravel_order(params)
        p_flat, g_flat = flatten(params), flatten(grads)
        g = torch.cat([g_flat[path].reshape(-1) for path in order])
        if self.reduce is not None:
            g = self.reduce(g)
        norm = torch.sqrt(torch.dot(g, g))
        g = g * torch.where(norm < self.clip, 1.0, self.clip / norm)
        state["count"].add_(1)
        bc1, bc2 = _bias_corrections(state["count"], self.b1, self.b2)
        m, v = state["m"], state["v"]
        m.mul_(self.b1).add_((1.0 - self.b1) * g)
        v.mul_(self.b2).add_(torch.mul(g, g).mul_(1.0 - self.b2))
        upd = (-self.lr) * (m / bc1) / torch.sqrt(v / bc2).add_(self.eps)
        leaves = [p_flat[path] for path in order]
        torch._foreach_add_(leaves, [u.view_as(p) for u, p in zip(
            upd.split([p.numel() for p in leaves]), leaves)])
        return norm


def make_optimizer(cfgv, flat=False, reduce=None, norm=None):
    """The phase-1 optimizer (clip ``cfgv.clip_grad``, Adam ``cfgv.lr``):
    the flat-vector Adam when ``flat`` (``config.flat_optimizer_enabled``),
    else the per-leaf one; ``reduce`` averages the gradients over the
    data-parallel ranks, ``norm`` is a model-parallel run's global norm
    (the per-leaf Adam's alone)."""
    if flat:
        return FlatAdam(cfgv.lr, cfgv.clip_grad, reduce=reduce)
    return ClipAdam(cfgv.lr, cfgv.clip_grad, reduce=reduce, norm=norm)
