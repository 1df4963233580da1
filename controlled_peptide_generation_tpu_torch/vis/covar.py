"""Latent covariance diagnostics: Cov_q(z) = E_p[Sigma] + Cov_p[mu]
(Kumar et al. 2018). To match the prior it should be I; its Frobenius
distance to I is the heldout health metric of phase-1 training."""

import numpy as np
import torch

from ..latent.density import empirical_covar


def cov_q(mus, logvars):
    """Returns (Cov_q, diag E_p[Sigma], diag Cov_p[mu]), float64 numpy."""
    Ep_Covq = np.diag(np.exp(np.asarray(logvars, np.float64)).mean(0))
    Covp_Eq = empirical_covar(
        torch.as_tensor(np.asarray(mus, np.float64))).numpy()
    return (Ep_Covq + Covp_Eq, np.diagonal(Ep_Covq), np.diagonal(Covp_Eq))


def frobenius_to_identity(C):
    C = np.asarray(C)
    return float(((C - np.eye(C.shape[0])) ** 2).sum())
