"""Loss library: reconstruction CE, Gaussian KLs, the flow-posterior KL
(``kl_flow_mc``), WAE-MMD (full and random-feature), as in the JAX
package's ``ops/losses.py``, quirks kept:

* ``mmd_full_kernel`` subtracts the diagonal vector broadcast over rows
  from H, not a zeroed diagonal (the logged ``L_wae_mmd`` depends on it);
* recon targets are the inputs shifted left with a PAD column appended,
  and PAD positions are left out of the mean;
* the random-feature basis of the RF-MMD is state the caller passes.

The prior samples of the WAE terms are drawn from a ``torch.Generator`` or
passed in (``z_prior``), so tests can feed the JAX package's draws.
"""

import math

import torch

from ..data.vocab import PAD_IDX
from . import cuda_build, mmd_kernel


def _targets(sequences):
    pad_col = torch.full((sequences.shape[0], 1), PAD_IDX,
                         dtype=sequences.dtype, device=sequences.device)
    return torch.cat([sequences[:, 1:], pad_col], dim=1).long()


def token_count(sequences):
    """The non-PAD targets of ``recon_dec`` in [B, T] int sequences (at
    least 1), a 0-d float32 tensor."""
    return (_targets(sequences) != PAD_IDX).sum().to(
        torch.float32).clamp_min(1.0)


def recon_dec(sequences, logits, count=None):
    """NLL of next-token predictions, ignoring PAD targets.

    sequences: [B, T] int; logits: [B, T, V]. Inputs '<start> A C ...
    <eos>' predict targets 'A C ... <eos> <pad>'. The NLL sum is divided
    by the batch's non-PAD target count, or by ``count`` (a data-parallel
    rank's rows divide by the global batch's count over the world size,
    ``parallel/collectives.py``)."""
    targets = _targets(sequences)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (targets != PAD_IDX).to(logits.dtype)
    if count is None:
        count = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / count


def kl_gaussianprior(mu, logvar):
    """KL( N(mu, sigma) || N(0, I) ), mean over the batch."""
    return (0.5 * (logvar.exp() + mu ** 2 - 1.0 - logvar).sum(1)).mean()


def kl_gaussian_sharedmu(mu, logvar):
    """KL( N(mu, sigma) || N(mu, I) ): penalizes logvar only."""
    del mu
    return (0.5 * (logvar.exp() - 1.0 - logvar).sum(1)).mean()


def mmd_full_kernel(z1, z2, sigma, kernel="gaussian"):
    """The WAE-MMD with the full kernel matrices and the diag quirk: kernel
    B5 (``ops/mmd_kernel.py``) on CUDA tensors, its plain versions on CPU
    tensors, the plain expression on any device inside
    ``cuda_build.plain()``."""
    if cuda_build.in_plain():
        return mmd_kernel.mmd_full_reference(z1, z2, sigma, kernel)
    return mmd_kernel.mmd_full(z1, z2, sigma, kernel)


def init_rf_basis(gen, z_dim, rf_dim, device="cpu"):
    """Random-feature basis (rf_w [z_dim, rf_dim], rf_b [rf_dim]) for the
    gaussian-kernel MMD estimator."""
    rf_w = torch.randn((z_dim, rf_dim), generator=gen, device=device)
    rf_b = 2.0 * math.pi * torch.rand((rf_dim,), generator=gen,
                                      device=device)
    return rf_w, rf_b


def _rf_embed(z, rf_w, rf_b, sigma):
    rf_dim = rf_w.shape[1]
    z_emb = (z @ rf_w) / sigma + rf_b
    return torch.cos(z_emb) * (2.0 / rf_dim) ** 0.5


def mmd_rf(z1, z2, rf_w, rf_b, sigma):
    mu1 = _rf_embed(z1, rf_w, rf_b, sigma).mean(0)
    mu2 = _rf_embed(z2, rf_w, rf_b, sigma).mean(0)
    return ((mu1 - mu2) ** 2).sum()


def _prior_like(z, gen, z_prior):
    if z_prior is None:
        z_prior = torch.randn(z.shape, generator=gen, device=z.device,
                              dtype=z.dtype)
    return z_prior


def wae_mmd_gaussianprior_full(z, sigma, kernel="gaussian", gen=None,
                               z_prior=None):
    """MMD(q(z), N(0, I)) against fresh prior samples (or ``z_prior``)."""
    return mmd_full_kernel(z, _prior_like(z, gen, z_prior), sigma, kernel)


def wae_mmd_gaussianprior_rf(z, rf_w, rf_b, sigma, gen=None, z_prior=None):
    return mmd_rf(z, _prior_like(z, gen, z_prior), rf_w, rf_b, sigma)


def kl_flow_mc(mu, logvar, z0, z_k, logdet):
    """The flow-posterior KL term, one Monte-Carlo sample a row (Rezende &
    Mohamed 2015): mean over the batch of log q0(z0 | x) - sum log|det J|
    - log p(z_K), p = N(0, I)."""
    log2pi = math.log(2.0 * math.pi)
    eps2 = (z0 - mu) ** 2 / logvar.exp()
    log_q0 = -0.5 * (log2pi + logvar + eps2).sum(1)
    log_p = -0.5 * (log2pi + z_k ** 2).sum(1)
    return (log_q0 - logdet - log_p).mean()
