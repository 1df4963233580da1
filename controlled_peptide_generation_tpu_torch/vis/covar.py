"""Latent covariance diagnostics: Cov_q(z) = E_p[Sigma] + Cov_p[mu]
(Kumar et al. 2018). To match the prior it should be I; its Frobenius
distance to I is the heldout health metric of phase-1 training.

The matrices are float64 on the device of the encodings (``device`` for
the numpy arrays of a states dump); only the figures go to the host.
"""

import logging

import numpy as np
import torch

from ..latent.density import empirical_covar
from ..utils import runtime
from . import build_index, figures

LOG = logging.getLogger("GenerationAPI")


def cov_q(mus, logvars, device=None):
    """Returns (Cov_q, diag E_p[Sigma], diag Cov_p[mu]), float64 tensors on
    ``device`` (default: that of ``mus``, the CPU for numpy arrays)."""
    mus = torch.as_tensor(mus, device=device).to(torch.float64)
    logvars = torch.as_tensor(logvars, device=mus.device).to(torch.float64)
    ep_var = torch.exp(logvars).mean(0)
    Covp_Eq = empirical_covar(mus)
    return torch.diag(ep_var) + Covp_Eq, ep_var, torch.diagonal(Covp_Eq)


def sorted_cov_diagonals(mus, logvars, sortix=None, device=None):
    """Mean encoder variance and activity Cov_p[mu], sorted by activity."""
    _, ep_var, activity = cov_q(mus, logvars, device)
    if sortix is None:
        sortix = torch.argsort(-activity)
    return ep_var[sortix], activity[sortix], sortix


def frobenius_to_identity(C):
    C = torch.as_tensor(C)
    return float(((C - torch.eye(C.shape[0], dtype=C.dtype,
                                 device=C.device)) ** 2).sum())


def get_enc(states, target, max_eval=500):
    lab = states["label"][:, 0] if states["label"].ndim > 1 \
        else states["label"]
    sel = np.flatnonzero(lab == target)[:max_eval]
    return (states["mu"][sel].astype(np.float32),
            states["logvar"][sel].astype(np.float32))


def figure_paths(fname, label_type):
    return [fname[:-3] + "_" + label_type + suffix for suffix in
            ("_q_phi_z.png", "_covar_diag.png", "_covar_offdiag.png")]


def analyze_one_set(C, d1, d2, label_type, fname, plt=None):
    """Returns the Frobenius distance of one Cov_q(z) to I, and draws its
    three figures with ``plt`` (``figures.pyplot``; None draws none)."""
    frob = frobenius_to_identity(C)
    LOG.info("Frobenius distance to identity for %s: %s.", label_type, frob)
    if plt is None:
        return frob
    paths = figure_paths(fname, label_type)
    C, d1, d2 = (t.cpu().numpy() for t in (C, d1, d2))
    plt.figure(figsize=(10, 10))
    plt.matshow(np.minimum(C, 3), fignum=1)
    plt.colorbar(fraction=0.046, pad=0.04)
    plt.title(r"Cov$_{q_\phi}(z)$ for " + label_type, pad=18, fontsize=18)
    plt.savefig(paths[0], dpi=150, format="png")
    plt.close()

    plt.figure(figsize=(10, 5))
    plt.plot(d1, label=r"diag $\mathbb{E}_p\ \sigma$")
    plt.plot(d2, label=r"diag $Cov_p\ \mu$")
    plt.plot(C.mean(0), label=r"means")
    plt.legend()
    plt.title(f"Diagonal of covariance for {label_type}", fontsize=18)
    plt.savefig(paths[1], dpi=150, format="png")
    plt.close()

    plt.figure(figsize=(10, 5))
    # strictly above the diagonal, as the JAX package draws it
    offdia = C[np.triu(np.ones_like(C), k=1) == 1]
    plt.hist(offdia, bins=100)
    plt.title(f"Histogram of off-diagonals for {label_type}", fontsize=18)
    plt.savefig(paths[2], dpi=150, format="png")
    plt.close()
    return frob


def build_covar(states, fname, max_evaluated=500, device="cuda"):
    """Cov_q(z) of the first ``max_evaluated`` positive and unlabeled rows
    (the first attribute) on ``device``; writes ``_frob_dist.txt``.
    Returns (frob_pos, frob_unl)."""
    unl_mu, unl_logvar = get_enc(states, -1, max_evaluated)
    pos_mu, pos_logvar = get_enc(states, 1, max_evaluated)
    C_pos, d1_pos, d2_pos = cov_q(pos_mu, pos_logvar, device)
    C_unl, d1_unl, d2_unl = cov_q(unl_mu, unl_logvar, device)
    plt = figures.pyplot(figure_paths(fname, "pos")
                         + figure_paths(fname, "unl"))
    frob_pos = analyze_one_set(C_pos, d1_pos, d2_pos, "pos", fname, plt)
    frob_unl = analyze_one_set(C_unl, d1_unl, d2_unl, "unl", fname, plt)
    with open(fname[:-3] + "_frob_dist.txt", "w") as g:
        g.write(f"Frobenius from identity for positive: {frob_pos}\n")
        g.write(f"Frobenius from identity for unlabeled: {frob_unl}\n")
    return frob_pos, frob_unl


def eval(fnames, device="cuda"):  # noqa: A001 - the JAX package's name
    """build_covar of the train split's states dump, on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    device = runtime.setup(device)
    fname = fnames["train"]
    return build_covar(build_index.read_states(fname), fname, device=device)
