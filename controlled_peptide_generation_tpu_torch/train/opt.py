"""The phase-1 optimizer: clip by global norm, then Adam, with optax's
formulas (the JAX package's ``optax.chain(clip_by_global_norm(c),
adam(lr))``).

* clip: with n the global norm over all leaves, g stays g when n < c and
  becomes (g / n) * c otherwise (``torch.nn.utils.clip_grad_norm_``
  scales by c / (n + 1e-6) instead, so it is not used);
* Adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
  update = -lr * mu_hat / (sqrt(nu_hat) + eps) with the bias corrections
  1 - b^count computed in float32.

The state is ``{"count", "mu", "nu"}`` with mu and nu nested like the
parameters; ``train/checkpoints.py`` maps it to optax's key paths.
Parameters are updated in place (the trainer owns them).
"""

import torch

from .checkpoints import flatten


def _zeros(tree):
    """Zeros nested like ``tree`` (dicts, and lists such as the
    transformer's blocks)."""
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


class ClipAdam:
    def __init__(self, lr, clip, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip = float(lr), float(clip)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        dev = next(iter(flatten(params).values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": _zeros(params), "nu": _zeros(params)}

    @staticmethod
    def global_norm(grads):
        return torch.sqrt(sum((g * g).sum() for g in flatten(grads).values()))

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` and ``state`` in place from ``grads`` (nested
        like params). Returns the global norm of the unclipped grads."""
        p_flat, g_flat = flatten(params), flatten(grads)
        mu, nu = flatten(state["mu"]), flatten(state["nu"])
        norm = self.global_norm(grads)
        keep = norm < self.clip
        count = state["count"] + 1
        state["count"].copy_(count)
        c32 = count.to(torch.float32)
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32,
                                 device=c32.device) ** c32
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32,
                                 device=c32.device) ** c32
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


def make_optimizer(cfgv, flat=False):
    """The phase-1 optimizer (clip ``cfgv.clip_grad``, Adam ``cfgv.lr``).
    The JAX package's flat-vector variant (``--hw.flat_optimizer on``) is
    not ported."""
    if flat:
        raise NotImplementedError(
            "hw.flat_optimizer on is not ported (ROADMAP.md A7)")
    return ClipAdam(cfgv.lr, cfgv.clip_grad)
