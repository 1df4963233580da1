"""Per-point latent density diagnostics.

One Gaussian per TRAINING point, ``N(mu_i, diag(sqrt(exp(logvar_i))))``:
the std used as the covariance, the ``to_var`` quirk the JAX package keeps
so that its numbers compare with the reference's. For each evaluated
latent z: the fraction of those Gaussians whose density does not underflow
to 0.0 in float64, and the mean density (a posterior-overlap / coverage
diagnostic). The whole [n_eval, n_train] density matrix is one float64
broadcast on the device.

The "zero" is float64 underflow (exp below about -745; denormals count as
non-zero). Sums in another order than numpy's can move an entry at that
boundary, so the fractions agree with the JAX package's within one
Gaussian (1 / n_train), not bit for bit.
"""

import logging
import math

import numpy as np
import torch

from ..utils import runtime
from . import build_index, figures

LOG = logging.getLogger("GenerationAPI")

LOG2PI = math.log(2.0 * math.pi)


def density_stats(mu, logvar, eval_z, device=None):
    """Coverage of eval_z under the per-point posteriors N(mu_i, to_var_i).

    Returns (nonzero_ratios [n_eval], mean_densities [n_eval]), float64
    tensors on ``device`` (default: that of ``mu``): per evaluated point,
    the fraction of the n_train Gaussians assigning it non-underflowed
    density, and its mean density."""
    mu = torch.as_tensor(mu, device=device).to(torch.float64)
    logvar, z = (torch.as_tensor(a, device=mu.device).to(torch.float64)
                 for a in (logvar, eval_z))
    cov = torch.sqrt(torch.exp(logvar))                 # to_var quirk
    z = torch.atleast_2d(z)
    D = mu.shape[1]
    logdet = torch.log(cov).sum(dim=1)                  # [n_train]
    prec = 1.0 / cov
    quad = (z ** 2 @ prec.T
            - 2.0 * (z @ (mu * prec).T)
            + torch.sum(mu ** 2 * prec, dim=1)[None, :])  # [n_eval, n_train]
    logp = -0.5 * (D * LOG2PI + logdet[None, :] + quad)
    dens = torch.exp(logp)  # float64 underflow to 0.0 is the "zero"
    return (dens > 0).to(torch.float64).mean(dim=1), dens.mean(dim=1)


def eval(fnames, label_dict=(), device="cuda"):  # noqa: A001 - JAX name
    """For each attribute and label (pos, neg, unl) with at least 10 rows:
    the density statistics of its first 500 train rows' z under all train
    rows' posteriors, on ``device`` (CUDA unless the caller asks for the
    CPU). Writes ``_kde.txt`` and a histogram each; returns {attr_tag:
    mean non-zero fraction}."""
    device = runtime.setup(device)
    fname = fnames["train"]
    states = build_index.read_states(fname)
    mu_all = torch.as_tensor(states["mu"], device=device).to(torch.float64)
    logvar_all = torch.as_tensor(states["logvar"], device=device).to(
        torch.float64)
    lab = states["label"]
    max_evaluated = 500

    results, lines, hists = {}, [], []
    for attr_ix, (attr_name, _) in enumerate(label_dict):
        for target, tag in [(1, "pos"), (0, "neg"), (-1, "unl")]:
            sel = np.flatnonzero(lab[:, attr_ix] == target)[:max_evaluated]
            if len(sel) < 10:
                continue
            ratios, dens = density_stats(mu_all, logvar_all,
                                         states["z"][sel])
            frac = float(ratios.mean())
            avg = float(dens.mean())
            results[f"{attr_name}_{tag}"] = frac
            lines.append(f"{attr_name}={tag}: {frac * 100:.2f}% Non-zero, "
                         f"{avg:.3e} Avg density")
            hists.append((fname[:-3] + f"_kde_{attr_name}_{tag}.png",
                          f"Fraction of Gaussians with non-zero density, "
                          f"{attr_name}={tag}", ratios))
            LOG.info("kde %s=%s: nonzero fraction %.4f, avg density %.3e",
                     attr_name, tag, frac, avg)
    with open(fname[:-3] + "_kde.txt", "w") as g:
        g.write("\n".join(lines))
    plt = figures.pyplot([path for path, _, _ in hists]) if hists else None
    if plt is not None:
        for path, title, ratios in hists:
            plt.figure(figsize=(8, 4))
            plt.hist(ratios.cpu().numpy(), bins=40, alpha=0.8)
            plt.title(title)
            plt.savefig(path, dpi=120)
            plt.close()
    return results
