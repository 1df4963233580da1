"""Normalizing flows on z: planar, radial and alternating (the JAX
package's ``models/flow.py``).

Each layer maps z [B, D] to z' and its log|det J| [B]:

* planar: z' = z + u * tanh(w.z + b), log|1 + psi.u + EPS|;
* radial: z' = z + beta h (z - z0), h = 1 / (alpha + |z - z0|).

'alternating' runs planar at even layers and radial at odd ones (both
families' parameters are allocated, as in the JAX package). The
invertibility constraints are applied at every call from the raw
parameters (planar: the scale projected so that scale.w >= -1 where the
margin is below -1; radial: beta lifted above -alpha), so their gradients
flow through the projection as in the JAX package. The parameter tree is
the JAX package's, ``{'planar': {'w', 'b', 'scale'}, 'radial': {'z0',
'alpha', 'beta'}}``, one row per layer, so checkpoints cross over.
"""

import torch

EPS = 1e-7


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def init(gen, flow_type, n_layers, z_dim, device="cpu"):
    """The seeded parameters of ``n_layers`` layers of ``flow_type``."""
    def planar():
        return {"w": _uniform(gen, (n_layers, z_dim), -0.01, 0.01, device),
                "b": _uniform(gen, (n_layers,), -0.01, 0.01, device),
                "scale": _uniform(gen, (n_layers, z_dim), -0.01, 0.01,
                                  device)}

    def radial():
        return {"z0": _uniform(gen, (n_layers, z_dim), -0.01, 0.01, device),
                "alpha": _uniform(gen, (n_layers,), 0.01, 1.0, device),
                "beta": _uniform(gen, (n_layers,), -0.01, 0.01, device)}

    if flow_type == "planar":
        return {"planar": planar()}
    if flow_type == "radial":
        return {"radial": radial()}
    if flow_type == "alternating":
        return {"planar": planar(), "radial": radial()}
    raise ValueError("Please use planar, radial, or alternating flow.")


def _planar_constrained_scale(w, scale):
    """scale + (softplus(m) - 1 - m) w / (|w| + EPS) where the margin m =
    scale.w is below -1, else scale."""
    margin = scale @ w
    correction = -1.0 + torch.log1p(torch.exp(margin)) - margin
    w_unit = w / (torch.linalg.vector_norm(w) + EPS)
    return torch.where(margin < -1.0, scale + correction * w_unit, scale)


def _planar_step(z, w, b, scale):
    scale = _planar_constrained_scale(w, scale)
    act = torch.tanh(z @ w + b)                              # [B]
    z_new = z + scale[None, :] * act[:, None]
    psi = (1.0 - act ** 2)[:, None] * w[None, :]             # [B, D]
    det = 1.0 + psi @ scale
    return z_new, torch.log(det.abs() + EPS)


def _radial_constrained_beta(alpha, beta):
    return torch.where(beta < -alpha, -alpha + torch.log1p(torch.exp(beta)),
                       beta)


def _radial_step(z, z0, alpha, beta, z_dim):
    beta = _radial_constrained_beta(alpha, beta)
    radius = z - z0[None, :]
    r = torch.linalg.vector_norm(radius, dim=1)              # [B]
    h = 1.0 / (alpha + r)
    z_new = z + beta * h[:, None] * radius
    bh = beta * h
    # an int exponent: a negative base keeps its sign
    det = (1.0 + bh) ** int(z_dim - 1) * (1.0 + bh + beta * (-h ** 2) * r)
    return z_new, torch.log(det.abs() + EPS)


def n_layers(params):
    if "planar" in params:
        return params["planar"]["b"].shape[0]
    return params["radial"]["alpha"].shape[0]


def apply(params, flow_type, z):
    """z [B, D] -> (z_K [B, D], the sum of the layers' log|det J| [B])."""
    z_dim = z.shape[1]
    logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for i in range(n_layers(params)):
        if flow_type == "planar" or (flow_type == "alternating"
                                     and i % 2 == 0):
            p = params["planar"]
            z, ld = _planar_step(z, p["w"][i], p["b"][i], p["scale"][i])
        else:
            p = params["radial"]
            z, ld = _radial_step(z, p["z0"][i], p["alpha"][i],
                                 p["beta"][i], z_dim)
        logdet = logdet + ld
    return z, logdet
