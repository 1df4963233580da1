"""Phase-1 training of the autoencoder, plainly: the WAE objective with
its random-feature MMD term, gradients by autograd, and Adam after a clip
of the gradients' global norm.

loss = recon + beta * mmdrf + lambda_L1 * |logvar|_1 + lambda_KL *
KL(N(mu, sigma) || N(mu, I)), beta annealed linearly; recon is the mean
next-token NLL over the non-PAD targets (the inputs shifted left, a PAD
appended). The full-kernel MMD (with the CLaSS reference's quirk of
subtracting H's diagonal broadcast over rows) is logged, not trained on.
Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr m_hat /
(sqrt(v_hat) + eps); g scaled by clip / |g| where |g| >= clip.

A step's random draws come from the generator of (seed, step) in a fixed
order, so the reference replays the draws a run's step takes.
"""

import math

import torch

from .common import PAD, generator, onehot
from .models import decode_logits, encode, leaves, word_dropout


def rf_basis(device, seed, z_dim, rf_dim):
    """The random-feature basis of a run: (w [Z, rf_dim], b [rf_dim])."""
    gen = generator(device, seed, 1)
    w = torch.randn((z_dim, rf_dim), generator=gen, device=device)
    return w, 2.0 * math.pi * torch.rand((rf_dim,), generator=gen,
                                         device=device)


def step_draws(cfg, device, seed, it, B):
    """The draws of step ``it``, in their order: eps, the c bits, the
    word-dropout mask, the GRU head's dropout mask, the two prior samples."""
    gen = generator(device, seed, it)
    T, Z = cfg["max_seq_len"], cfg["z_dim"]

    def normal(shape):
        return torch.empty(shape, device=device).normal_(generator=gen)

    def below(shape, p):
        return torch.empty(shape, device=device).uniform_(generator=gen) < p

    d = {"eps": normal((B, Z)), "c_bits": below((B,), 0.5),
         "word_drop": below((B, T), cfg["p_word_dropout"])}
    if cfg["family"] == "gru":
        d["out_keep"] = below((B, T, Z + cfg["c_dim"]),
                              1.0 - cfg["p_out_dropout"])
    d["z_prior_mmd"] = normal((B, Z))
    d["z_prior_rf"] = normal((B, Z))
    return d


def beta_at(cfg, it):
    s, e = cfg["beta"]
    frac = min(max((it - s[1]) / max(e[1] - s[1], 1), 0.0), 1.0)
    return s[0] + (e[0] - s[0]) * frac


def mmd_full(z1, z2, sigma):
    """The gaussian-kernel MMD with the reference's diagonal quirk, in
    float64."""
    z1, z2 = z1.double(), z2.double()
    n = z1.shape[0]

    def k(a, b):
        return torch.exp(-((a[:, None] - b[None]) ** 2).sum(2) / sigma ** 2)

    H = k(z1, z1) + k(z2, z2) - 2.0 * k(z1, z2)
    return float((H - torch.diagonal(H)[None, :]).sum() / (n * (n - 1)))


def _rf_mean(z, w, b, sigma):
    return (torch.cos(z @ w / sigma + b) * (2.0 / w.shape[1]) ** 0.5).mean(0)


def loss_fn(cfg, params, text, beta, draws, rf):
    """(loss, z) of one batch."""
    mu, logvar = encode(cfg, params, text)
    z = mu + torch.exp(logvar / 2.0) * draws["eps"]
    c = onehot(draws["c_bits"], cfg["c_dim"])
    logits = decode_logits(cfg, params, word_dropout(text, draws["word_drop"]),
                           z, c, draws.get("out_keep"),
                           cfg.get("p_out_dropout", 0.0))
    targets = torch.cat([text[:, 1:], torch.full_like(text[:, :1], PAD)],
                        1).long()
    nll = -torch.log_softmax(logits, -1).gather(-1, targets[..., None])[..., 0]
    mask = (targets != PAD).to(nll.dtype)
    recon = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    diff = _rf_mean(z, *rf, cfg["sigma"]) - _rf_mean(draws["z_prior_rf"], *rf,
                                                     cfg["sigma"])
    mmdrf = (diff ** 2).sum()
    l1 = logvar.abs().sum(1).mean()
    kl_shared = (0.5 * (logvar.exp() - 1.0 - logvar).sum(1)).mean()
    loss = (recon + beta * mmdrf + cfg["lambda_logvar_L1"] * l1
            + cfg["lambda_logvar_KL"] * kl_shared)
    return loss, z


class Adam:
    """Adam after a global-norm clip; its state is per leaf path."""

    def __init__(self, cfg, params):
        self.lr, self.clip = cfg["lr"], cfg["clip_grad"]
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.m = {p: torch.zeros_like(v) for p, v in leaves(params)}
        self.v = {p: torch.zeros_like(v) for p, v in leaves(params)}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """Update ``params`` in place from {path: gradient}; returns the
        clipped gradients the moments took."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / norm
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        used = {}
        for path, p in leaves(params):
            g = grads[path] * scale
            used[path] = g
            self.m[path].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[path].mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (self.m[path] / bc1)
                   / (torch.sqrt(self.v[path] / bc2) + self.eps))
        return used


def run_steps(cfg, params, texts, its, seed):
    """Train ``params`` (updated in place) on texts[i] at step its[i]; returns
    per step (loss, mmd), and the clipped gradients of the first step."""
    dev = texts[0].device
    rf = rf_basis(dev, seed, cfg["z_dim"], cfg["rf_dim"])
    opt = Adam(cfg, params)
    out, first_grads = [], None
    for text, it in zip(texts, its):
        draws = step_draws(cfg, dev, seed, it, text.shape[0])
        flat = leaves(params)
        for _, leaf in flat:
            leaf.requires_grad_(True)
        loss, z = loss_fn(cfg, params, text, beta_at(cfg, it), draws, rf)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in flat])
        for _, leaf in flat:
            leaf.requires_grad_(False)
        used = opt.step(params, {p: g for (p, _), g in zip(flat, grads)})
        if first_grads is None:
            first_grads = used
        out.append((float(loss.detach()),
                    mmd_full(z.detach(), draws["z_prior_mmd"], cfg["sigma"])))
    return out, first_grads
