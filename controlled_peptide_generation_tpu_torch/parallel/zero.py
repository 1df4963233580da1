"""ZeRO-1: Adam's moments sharded over the data-parallel ranks (the JAX
package's ``make_zero_train_step``, ``parallel/zero.py:50`` there, phase 1
only as there).

The JAX form constrains the gradients to the moments' shardings and lets
XLA place the collectives; here they are written out, on the parameters
raveled into one vector (``checkpoints.ravel_order``, the JAX package's
ravel order) and cut into ``world`` contiguous segments of ceil(n /
world) entries, the last zero-padded (at most world - 1 entries, whose
gradients, moments and updates stay 0). Rank r holds m and v of segment r
alone. A step:

1. the gradients, raveled and padded, are reduce-scattered to the rank's
   segment, averaged over the ranks as in plain DP
   (``collectives.Shard``);
2. the clip's global norm is the square root of the all-reduced sum of
   the segments' squares (``zero.py:63, 92`` there);
3. clip and Adam run on the segment with ``ClipAdam``'s formulas
   (optax's ``clip_by_global_norm`` and ``adam``, which the JAX ZeRO step
   chains whatever ``hw.flat_optimizer`` says);
4. the updated segments are all-gathered back into every rank's
   parameters.

The trajectory is plain DP's up to the order of the norm's sum. A
checkpoint holds the per-leaf Adam state gathered in full
(``full_state``), the file a one-device run of the per-leaf Adam writes,
so the JAX package and the port at ``hw.dp 1`` resume it;
``from_full`` cuts a rank's segments out of such a state.
"""

import torch

from ..train.checkpoints import flatten, ravel_order, unflatten
from ..train.opt import _bias_corrections, _device


class ZeroAdam:
    """Clip by global norm, then Adam, with m and v sharded 1 / world over
    ``shard``'s ranks (``collectives.Shard``)."""

    def __init__(self, lr, clip, shard, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip = float(lr), float(clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.shard = shard

    def layout(self, params):
        """(ravel order, leaf sizes, segment length, padding)."""
        order = ravel_order(params)
        flat = flatten(params)
        sizes = [flat[p].numel() for p in order]
        n = sum(sizes)
        seg = -(-n // self.shard.world)
        return order, sizes, seg, seg * self.shard.world - n

    def _ravel(self, tree, order, pad):
        flat = flatten(tree)
        parts = [flat[p].reshape(-1) for p in order]
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def _own(self, vec, seg):
        return vec[self.shard.rank * seg:(self.shard.rank + 1) * seg]

    def init(self, params):
        _, _, seg, _ = self.layout(params)
        dev = _device(params)
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "m": torch.zeros((seg,), device=dev),
                "v": torch.zeros((seg,), device=dev)}

    @torch.no_grad()
    def step(self, params, grads, state):
        """Update ``params`` (every rank's, in full) and this rank's
        ``state`` in place. Returns the global norm of the unclipped,
        averaged gradients."""
        order, sizes, seg, pad = self.layout(params)
        g = self.shard.reduce_scatter_mean(self._ravel(grads, order, pad))
        norm = torch.sqrt(self.shard.sum_(torch.dot(g, g)))
        g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
        state["count"].add_(1)
        bc1, bc2 = _bias_corrections(state["count"], self.b1, self.b2)
        m, v = state["m"], state["v"]
        m.copy_((1 - self.b1) * g + self.b1 * m)
        v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        own = self._own(self._ravel(params, order, pad), seg)
        full = self.shard.all_gather_flat(own + (-self.lr * upd))
        p_flat = flatten(params)
        leaves = [p_flat[p] for p in order]
        for u, p in zip(full[:sum(sizes)].split(sizes), leaves):
            p.copy_(u.view_as(p))
        return norm

    def full_state(self, params, state):
        """The per-leaf Adam state ({'count', 'mu', 'nu'}, ``ClipAdam``'s)
        of the ranks' segments gathered in full: a collective every rank
        calls."""
        order, sizes, _, _ = self.layout(params)
        out = {"count": state["count"].clone()}
        for name, key in (("mu", "m"), ("nu", "v")):
            full = self.shard.all_gather_flat(state[key])[:sum(sizes)]
            out[name] = unflatten(dict(zip(order, (
                t.view_as(flatten(params)[p]) for t, p in zip(
                    full.split(sizes), order)))))
        return out

    def from_full(self, params, full):
        """This rank's state from a per-leaf Adam state in full."""
        order, _, seg, pad = self.layout(params)
        return {"count": full["count"].clone(),
                "m": self._own(self._ravel(full["mu"], order, pad),
                               seg).clone(),
                "v": self._own(self._ravel(full["nu"], order, pad),
                               seg).clone()}
