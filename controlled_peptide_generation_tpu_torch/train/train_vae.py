"""Phase-1 WAE/VAE training on one device, of the GRU family and of the
transformer family (both parts transformer).

Adam over the autoencoder's parameters with a linearly annealed beta:
loss = recon + beta * z_regu + lambda1 * |logvar|_1 + lambda2 *
KL_sharedmu, gradients clipped to global norm 5.0; kl, mmd and mmdrf are
all computed every step (the reference logs all three whichever one
regularizes), the full-kernel MMD in the CUDA kernel B5
(``ops/mmd_kernel.py``) on a CUDA device. A GRU step runs three GRU
recurrences forward (encoder forward and backward directions,
teacher-forced decoder) and their three gradient recurrences backward, in
the CUDA kernels B2 of ``ops/gru_kernel.py``; the heldout eval runs its
scans without autograd, in the forward-only kernel B4
(``ops/gru_fwd_kernel.py``).

Every random draw of a step comes from ``draw_step`` with the generator of
(seed, it), so a step is reproducible from its iteration alone, and the
draws can be handed in (tests feed the JAX package's). The JAX package's
scan/unroll and buffer donation are dispatch devices of jit; the port runs
eagerly and ``hw.unroll`` / ``hw.donate_state`` have no effect.
"""

import logging
import sys
import time

import torch
from torch.profiler import record_function

from ..generation import generate_sentences
from ..ops import losses as L
from ..utils import runtime
from ..utils.annealing import anneal
from ..utils.logging import DeferredFetch
from ..vis.covar import cov_q, frobenius_to_identity
from . import checkpoints
from .opt import make_optimizer

log = logging.getLogger(__name__)

WARM_STEPS = 20        # steps left out of train_steps_per_sec_warm
# generator streams besides the per-step ones, keyed (seed, stream, it)
_RF_STREAM, _LOG_STREAM, _HELDOUT_STREAM = 1, 2, 3

SINK_KEYS = ("z_mu_L1", "z_logvar", "z_logvar_L1", "z_logvar_KL_penalty",
             "L_vae", "L_vae_recon", "L_vae_kl", "L_wae_mmd", "L_wae_mmdrf",
             "beta")


def check_supported(cfg):
    """Raise NotImplementedError for what the port's trainer does not run
    yet (ROADMAP.md A12); flows raise where the model is built."""
    hw = cfg.hw
    for name in ("dp", "tp", "pp"):
        if int(hw.get(name, 1) or 1) > 1:
            raise NotImplementedError(
                f"hw.{name} > 1 is not ported (ROADMAP.md A12)")
    if int(hw.get("dp", 1)) == 0:
        raise NotImplementedError("hw.dp 0 (all devices) is not ported "
                                  "(ROADMAP.md A12)")
    if hw.get("zero", False):
        raise NotImplementedError("hw.zero is not ported (ROADMAP.md A12)")
    if hw.get("profile_dir", ""):
        raise NotImplementedError("hw.profile_dir is not ported")


def _block_keeps(t_args, gen, B, S, device):
    """One bool dropout mask [B, S, d_model] per transformer block."""
    shape = (B, S, t_args.get("d_model", 128))
    p_keep = 1.0 - t_args["p_dropout"]
    return [torch.rand(shape, generator=gen, device=device) < p_keep
            for _ in range(t_args.get("n_layers", 2))]


def draw_step(model, gen, B, T, device, rf_dim=None):
    """Every random draw of one train step (bool dropout masks at the
    model's rates), in this order: eps [B, Z] (reparameterization), c_bits
    [B], word_drop [B, T]; the GRU decoder's out_keep [B, T, H]; the
    transformer blocks' masks when they have dropout, enc_keeps ([B, T,
    d_model] each) and dec_keeps ([B, T + 1, d_model] each); z_prior_mmd
    and z_prior_rf [B, Z] (the WAE terms' prior samples); and with
    ``rf_dim`` a fresh RF basis rf_w [Z, rf_dim], rf_b [rf_dim]."""
    tfm_dec = model.G_class == "transformer"
    g_args = model.dec_tfm_args if tfm_dec else model.gru_args
    p_wd = g_args.get("p_word_dropout", 0.3)
    Z = model.z_dim
    draws = {
        "eps": torch.randn((B, Z), generator=gen, device=device),
        "c_bits": torch.rand((B,), generator=gen, device=device) < 0.5,
        "word_drop": torch.rand((B, T), generator=gen, device=device) < p_wd,
    }
    if not tfm_dec:
        p_keep = 1.0 - g_args.get("p_out_dropout", 0.3)
        draws["out_keep"] = torch.rand((B, T, model.h_dec), generator=gen,
                                       device=device) < p_keep
    for name, on, t_args, S in (
            ("enc_keeps", model.E_class == "transformer", model.enc_tfm_args,
             T),
            ("dec_keeps", tfm_dec, model.dec_tfm_args, T + 1)):
        if on and t_args.get("p_dropout", 0.0) > 0.0:
            draws[name] = _block_keeps(t_args, gen, B, S, device)
    draws["z_prior_mmd"] = torch.randn((B, Z), generator=gen, device=device)
    draws["z_prior_rf"] = torch.randn((B, Z), generator=gen, device=device)
    if rf_dim is not None:
        draws["rf_w"], draws["rf_b"] = L.init_rf_basis(gen, Z, rf_dim,
                                                       device)
    return draws


def make_loss_fn(model, cfgv, mmd_cfg, rf_basis):
    """The phase-1 objective: loss_fn(params, text, beta, draws) ->
    (loss, metrics). rf_basis: the fixed (rf_w, rf_b), or None to take
    the basis from the draws (rf_resample)."""
    z_regu_name = cfgv.z_regu_loss

    def loss_fn(params, text, beta, draws):
        (mu, logvar), (z, c), dec_logits = model.forward(
            params, text, q_c="prior", sample_z=1, train=True, draws=draws)
        kl = L.kl_gaussianprior(mu, logvar)
        recon = L.recon_dec(text, dec_logits)
        mmd = L.wae_mmd_gaussianprior_full(z, mmd_cfg.sigma, mmd_cfg.kernel,
                                           z_prior=draws["z_prior_mmd"])
        rf_w, rf_b = (rf_basis if rf_basis is not None
                      else (draws["rf_w"], draws["rf_b"]))
        mmdrf = L.wae_mmd_gaussianprior_rf(z, rf_w, rf_b, mmd_cfg.sigma,
                                           z_prior=draws["z_prior_rf"])
        z_regu = {"kl": kl, "mmd": mmd, "mmdrf": mmdrf}[z_regu_name]
        z_logvar_L1 = logvar.abs().sum(1).mean()
        z_logvar_KL_penalty = L.kl_gaussian_sharedmu(mu, logvar)
        loss = (recon + beta * z_regu
                + cfgv.lambda_logvar_L1 * z_logvar_L1
                + cfgv.lambda_logvar_KL * z_logvar_KL_penalty)
        metrics = {
            "z_mu_L1": mu.abs().mean(),
            "z_logvar": logvar.mean(),
            "z_logvar_L1": z_logvar_L1,
            "z_logvar_KL_penalty": z_logvar_KL_penalty,
            "L_vae": loss,
            "L_vae_recon": recon,
            "L_vae_kl": kl,
            "L_wae_mmd": mmd,
            "L_wae_mmdrf": mmdrf,
        }
        return loss, metrics

    return loss_fn


def loss_and_grads(loss_fn, params, text, beta, draws):
    """(loss, metrics, grads nested like params) of one step. The
    ``record_function`` ranges here and in train_step name the parts of a
    step for tools/profile_train.py; without a profiler attached no
    callback runs for them."""
    flat = checkpoints.flatten(params)
    with record_function("forward"):
        loss, metrics = loss_fn(params, text, beta, draws)
    with record_function("backward"):
        grads = torch.autograd.grad(loss, list(flat.values()))
    grads = checkpoints.unflatten(dict(zip(flat, grads)))
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, cfgv, cfg_losses, rf_basis):
    """train_step(params, opt_state, text, it, draws) -> metrics (0-d
    tensors on the device); updates params and opt_state in place."""
    optimizer = make_optimizer(cfgv)
    loss_fn = make_loss_fn(model, cfgv, cfg_losses.wae_mmd, rf_basis)

    def train_step(params, opt_state, text, it, draws):
        beta = anneal(cfgv.beta, it)
        _, metrics, grads = loss_and_grads(loss_fn, params, text, beta,
                                           draws)
        with record_function("optimizer"):
            metrics["grad_norm"] = optimizer.step(params, grads, opt_state)
        metrics["beta"] = beta
        return metrics

    return train_step, optimizer


@torch.no_grad()
def evaluate_heldout(model, params, dataset, gen, n_batches=4,
                     iterator="hld_vae"):
    """Mean heldout recon/KL over a few val batches, and the Frobenius
    distance of Cov_q(z) over their encodings to I. None when the dataset
    has no such iterator."""
    if iterator not in dataset._iters:
        return None
    dev = next(iter(checkpoints.flatten(params).values())).device
    recons, kls, mus, lvs = [], [], [], []
    for _ in range(n_batches):
        text = torch.from_numpy(dataset.next_batch(iterator).text).to(dev)
        (mu, lv), _, logits = model.forward(params, text, q_c="prior",
                                            sample_z=1, train=False,
                                            gen=gen)
        recons.append(L.recon_dec(text, logits))
        kls.append(L.kl_gaussianprior(mu, lv))
        mus.append(mu)
        lvs.append(lv)
    C, _, _ = cov_q(torch.cat(mus).cpu().numpy(),
                    torch.cat(lvs).cpu().numpy())
    return {"recon": torch.stack(recons).mean().item(),
            "kl": torch.stack(kls).mean().item(),
            "cov_frob": frobenius_to_identity(C)}


def train_vae(cfg, model, dataset, params, logger=None, on_checkpoint=None):
    """Run the phase-1 loop on the device the params live on. Updates
    params in place; returns (params, opt_state, steps_per_sec), the rate
    over the whole loop (the rate after the first WARM_STEPS steps is
    logged as train_steps_per_sec_warm)."""
    check_supported(cfg)
    cfgv = cfg.vae
    dev = next(iter(checkpoints.flatten(params).values())).device
    mmd_cfg = cfg.losses.wae_mmd
    rf_basis = None
    if not mmd_cfg.rf_resample:
        rf_basis = L.init_rf_basis(
            runtime.generator(dev, cfg.seed, _RF_STREAM), model.z_dim,
            mmd_cfg.rf_dim, dev)
    train_step, optimizer = make_train_step(model, cfgv, cfg.losses,
                                            rf_basis)
    opt_state = optimizer.init(params)
    if cfg.loadpath:
        params, opt_state = checkpoints.load_train_state(
            cfg.loadpath, params, opt_state, dev)
        log.info("Loaded train state from %s", cfg.loadpath)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)

    def sink(p_it, vals, p_sent):
        if logger is not None:
            for k in SINK_KEYS:
                logger.log_value("train_" + k, vals[k], p_it)
        log.info(
            "ITER %d TRAINING (phase 1). loss_vae: %.4f; loss_recon: "
            "%.4f; loss_kl: %.4f; loss_mmd: %.4f; Grad_norm: %.4e",
            p_it, vals["L_vae"], vals["L_vae_recon"], vals["L_vae_kl"],
            vals["L_wae_mmd"], vals["grad_norm"])
        log.info('Sample (cat T=1.0): "%s"', dataset.idx2sentence(p_sent[0]))
        sys.stdout.flush()

    fetch = DeferredFetch(cfg.hw.get("log_flush_every", 10), sink)

    def do_host(it, metrics):
        cheap = it % cfgv.cheaplog_every == 0
        expsv = it % cfgv.expsvlog_every == 0
        if cheap or expsv:
            sent, _, _ = generate_sentences(
                model, params, 1,
                gen=runtime.generator(dev, cfg.seed, _LOG_STREAM, it),
                sample_mode="categorical", device=dev)
            fetch.add(it, metrics, sent, force=expsv)
        if expsv and it > cfgv.s_iter:
            path = cfgv.chkpt_path.format(it)
            checkpoints.save(path, params, opt_state, step=it)
            log.info("Saved model to %s", path)
            if cfg.hw.get("heldout_eval", True):
                hld = evaluate_heldout(
                    model, params, dataset,
                    runtime.generator(dev, cfg.seed, _HELDOUT_STREAM, it))
                if hld is not None:
                    if logger is not None:
                        for k, v in hld.items():
                            logger.log_value("hld_" + k, v, it)
                    log.info("HELDOUT recon: %.4f kl: %.4f", hld["recon"],
                             hld["kl"])
            if on_checkpoint is not None:
                on_checkpoint(it, params)

    log.info("Training base vae ...")
    it, end_it = cfgv.s_iter, cfgv.s_iter + cfgv.n_iter
    warm_it = it + WARM_STEPS
    t_start = t_warm = time.perf_counter()
    B, T = cfgv.batch_size, cfg.max_seq_len
    while it <= end_it:
        if it == warm_it:
            runtime.synchronize(dev)
            t_warm = time.perf_counter()
        text = torch.from_numpy(dataset.next_batch("train_vae").text).to(dev)
        draws = draw_step(model, runtime.generator(dev, cfg.seed, it), B, T,
                          dev, None if rf_basis is not None
                          else mmd_cfg.rf_dim)
        metrics = train_step(params, opt_state, text, it, draws)
        do_host(it, metrics)
        it += 1
    fetch.flush()
    runtime.synchronize(dev)
    t_end = time.perf_counter()
    steps_per_sec = (cfgv.n_iter + 1) / max(t_end - t_start, 1e-9)
    if logger is not None:
        logger.log_value("train_steps_per_sec", steps_per_sec, end_it)
        if end_it >= warm_it:
            logger.log_value("train_steps_per_sec_warm",
                             (end_it + 1 - warm_it)
                             / max(t_end - t_warm, 1e-9), end_it)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(False)
    return params, opt_state, steps_per_sec
