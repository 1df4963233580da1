"""Phase-1 WAE/VAE training on one device, of every family and option of
the model: GRU or transformer encoders; GRU (with or without skip
connections), transformer or deconv decoders; a posterior flow on z.

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
draws can be handed in (tests feed the JAX package's).

``--hw.unroll`` (default 50) is the JAX package's scan over steps
(``make_train_scan``): the loop takes each run of ``aligned_unroll`` steps
that needs no host work before its last step as one ``TrainChunk``, on the
card one captured CUDA graph of the whole run of steps (forward, backward
and optimizer, B2 and B5 inside it), replayed after its inputs (texts,
betas and every step's draws, drawn eagerly from the per-step generators)
are staged; on the CPU the same steps run eagerly. The updates are the
per-step path's. ``--hw.unroll 1`` runs every step eagerly.
``hw.donate_state`` (jit's buffer donation) has no counterpart.

Under a process group (``parallel/dist.py``, torchrun's ranks) the loop
is the JAX package's data-parallel one (``make_dp_train_step``,
``make_dp_train_scan``; with ``hw.zero`` ``make_zero_train_step``): the
step on the global batch, each rank running its rows
(``parallel/collectives.py`` says how), the gradients averaged over the
ranks inside the step, and inside a chunk's CUDA graph under NCCL; rank 0
alone writes logs, samples and checkpoints.

With ``hw.tp`` or ``hw.pp`` > 1 the group is a (data, pipe, model) mesh
(``parallel/dist.py`` ``Mesh``) and the loop is the JAX package's
tensor- and pipeline-parallel one (``make_tp_train_step`` on a 2D or 3D
mesh, ``make_pp_model``, each composed with ``hw.dp``; l. 268-338
there): the transformer legs run each rank's part (``parallel/tp.py``,
``parallel/pp.py``), the optimizer steps the rank's slices with the
global norm over the mesh, the checkpoints hold the full tree gathered
from the ranks (the file a one-device run writes), and every rank runs
its part of the heldout eval. Under TP every step is eager, as in JAX;
``hw.zero`` is not applied there (JAX takes the TP/PP branch first).
"""

import json
import logging
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import config as C
from ..generation import generate_sentences
from ..ops import losses as L
from ..ops import sampling
from ..parallel import collectives, dist as pdist
from ..parallel.zero import ZeroAdam
from ..utils import runtime, tracing
from ..utils.annealing import anneal
from ..utils.logging import DeferredFetch
from ..vis.covar import cov_q, frobenius_to_identity
from . import checkpoints
from .chunk import GraphChunk
from .opt import make_optimizer

log = logging.getLogger(__name__)

WARM_STEPS = 20        # steps left out of train_steps_per_sec_warm
# generator streams besides the per-step ones, keyed (seed, stream, it)
_RF_STREAM, _LOG_STREAM, _HELDOUT_STREAM = 1, 2, 3

SINK_KEYS = ("z_mu_L1", "z_logvar", "z_logvar_L1", "z_logvar_KL_penalty",
             "L_vae", "L_vae_recon", "L_vae_kl", "L_wae_mmd", "L_wae_mmdrf",
             "beta")


def check_chunk(group, device, unroll):
    """Raise a ValueError for a chunk of more than one step whose
    collectives cannot be captured in a CUDA graph: a gloo group (a
    ``collectives.Shard`` or a ``dist.Mesh``) on CUDA tensors (gloo stages
    them through the host). Runs of steps then need ``--hw.unroll 1``; CPU
    tensors run any chunk eagerly."""
    if (group is not None and unroll > 1 and group.backend == "gloo"
            and torch.device(device).type == "cuda"):
        raise ValueError(
            f"--hw.unroll {unroll} under a gloo group on CUDA tensors: a "
            f"chunk is one captured CUDA graph and gloo's collectives "
            f"cannot be captured; pass --hw.unroll 1 (or run NCCL)")


def aligned_unroll(unroll, *cadences):
    """Largest chunk width <= unroll that divides every log cadence (the
    JAX package's ``aligned_unroll``): chunks then end on the host's
    boundaries instead of straddling them."""
    g = math.gcd(*cadences)
    for d in range(min(unroll, g), 0, -1):
        if g % d == 0:
            return d
    return 1


class Drawer:
    """The random draws of ``draw_step``, each either a new tensor or
    written into the tensor of ``out`` under its name (bitwise the same:
    ``torch.randn`` and ``torch.rand`` are ``normal_`` and ``uniform_`` of
    an empty tensor)."""

    def __init__(self, gen, device, out):
        self.gen, self.device, self.out = gen, device, out

    def _into(self, name, i, shape, dtype):
        if self.out is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        buf = self.out[name]
        return buf if i is None else buf[i]

    def normal(self, name, shape):
        return self._into(name, None, shape, torch.float32).normal_(
            generator=self.gen)

    def gumbel(self, name, shape):
        """Standard Gumbel noise (``sampling.gumbel``)."""
        return sampling.gumbel(shape, self.gen, self.device,
                               None if self.out is None
                               else self.out[name])

    def below(self, name, shape, p, i=None):
        """A bool mask, True where a uniform draw is below p."""
        u = torch.empty(shape, device=self.device).uniform_(
            generator=self.gen)
        if self.out is None:
            return u < p
        return torch.lt(u, p, out=self._into(name, i, shape, torch.bool))


# draw_step's draws with one row per row of the batch: a data-parallel
# rank takes its rows of these, and the prior samples of the WAE terms and
# a resampled RF basis stay global
ROW_DRAWS = {k: 0 for k in ("eps", "c_bits", "word_drop", "out_keep",
                            "enc_keeps", "dec_keeps")}


def draw_step(model, gen, B, T, device, rf_dim=None, out=None):
    """Every random draw of one train step (bool dropout masks at the
    model's rates), in this order: eps [B, Z] (reparameterization), c_bits
    [B], word_drop [B, T]; the GRU decoder's out_keep [B, T, H]; the
    transformer blocks' masks when they have dropout, enc_keeps ([B, T,
    d_model] each) and dec_keeps ([B, T + 1, d_model] each); z_prior_mmd
    and z_prior_rf [B, Z] (the WAE terms' prior samples); and with
    ``rf_dim`` a fresh RF basis rf_w [Z, rf_dim], rf_b [rf_dim]. With
    ``out`` (the dict of an earlier call at the same shapes, without
    ``rf_dim``) the draws are written into its tensors."""
    tfm_dec = model.G_class == "transformer"
    g_args = model.dec_tfm_args if tfm_dec else model.gru_args
    p_wd = g_args.get("p_word_dropout", 0.3)
    Z = model.z_dim
    d = Drawer(gen, device, out)
    draws = {
        "eps": d.normal("eps", (B, Z)),
        "c_bits": d.below("c_bits", (B,), 0.5),
        "word_drop": d.below("word_drop", (B, T), p_wd),
    }
    if model.G_class == "gru":
        p_keep = 1.0 - g_args.get("p_out_dropout", 0.3)
        draws["out_keep"] = d.below("out_keep", (B, T, model.h_dec), p_keep)
    for name, on, t_args, S in (
            ("enc_keeps", model.E_class == "transformer", model.enc_tfm_args,
             T),
            ("dec_keeps", tfm_dec, model.dec_tfm_args, T + 1)):
        if on and t_args.get("p_dropout", 0.0) > 0.0:
            shape = (B, S, t_args.get("d_model", 128))
            p_keep = 1.0 - t_args["p_dropout"]
            draws[name] = [d.below(name, shape, p_keep, i)
                           for i in range(t_args.get("n_layers", 2))]
    draws["z_prior_mmd"] = d.normal("z_prior_mmd", (B, Z))
    draws["z_prior_rf"] = d.normal("z_prior_rf", (B, Z))
    if rf_dim is not None:
        draws["rf_w"], draws["rf_b"] = L.init_rf_basis(gen, Z, rf_dim,
                                                       device)
    return draws


def flow_forward(model, params, text, train, draws, gen=None):
    """The flow-posterior forward (the JAX package's flow arm): z0 ~ q(z |
    x), z_K = flow(z0) decoded with c of the prior. ``draws`` as in
    ``model.forward`` ("eps", "c_bits" and the dropout masks; the others
    from ``gen``). Returns (mu, logvar, z_K, the decoder's logits, the
    flow posterior's KL, ``losses.kl_flow_mc``)."""
    mu, logvar = model.encode(params, text, train=train, gen=gen,
                              keeps=draws.get("enc_keeps"))
    z0 = model.sample_z(mu, logvar, gen, draws.get("eps"))
    z, logdet = model.apply_flow(params, z0)
    bits = draws.get("c_bits")
    c = (model.sample_c_prior(gen, text.shape[0], device=text.device)
         if bits is None else model.c_from_bits(bits))
    dec_logits = model.decode_train(
        params, text, z, c, train=train, gen=gen,
        word_drop=draws.get("word_drop"), out_keep=draws.get("out_keep"),
        keeps=draws.get("dec_keeps"))
    return mu, logvar, z, dec_logits, L.kl_flow_mc(mu, logvar, z0, z,
                                                   logdet)


def make_loss_fn(model, cfgv, mmd_cfg, rf_basis, shard=None):
    """The phase-1 objective: loss_fn(params, text, beta, draws) ->
    (loss, metrics). rf_basis: the fixed (rf_w, rf_b), or None to take
    the basis from the draws (rf_resample). A model with a flow (under
    flow_mode 'posterior') decodes z_K = flow(z0), and its 'kl' term is
    the flow posterior's (``losses.kl_flow_mc``), the JAX package's flow
    arm; its MMD terms act on z_K. With a ``shard``
    (``collectives.Shard``) text and draws are the global batch's, the
    rank's rows run the model, and the coupled terms are global
    (``parallel/collectives.py``)."""
    z_regu_name = cfgv.z_regu_loss
    if model.flow > 0 and model.flow_mode != "posterior":
        raise ValueError(
            "training with a flow requires model.flow_mode='posterior' "
            "(gen_prior matches the reference, whose forward raises during "
            "training, model.py:173-177)")

    def loss_fn(params, text, beta, draws):
        count = None
        if shard is not None:
            count = L.token_count(text) / shard.world
            text, draws = shard.rows(text), shard.rows_of(draws, ROW_DRAWS)
        if model.flow > 0:
            mu, logvar, z, dec_logits, kl = flow_forward(model, params,
                                                         text, True, draws)
        else:
            (mu, logvar), (z, c), dec_logits = model.forward(
                params, text, q_c="prior", sample_z=1, train=True,
                draws=draws)
            kl = L.kl_gaussianprior(mu, logvar)
        recon = L.recon_dec(text, dec_logits, count)
        z_all = z if shard is None else shard.gather(z)
        mmd = L.wae_mmd_gaussianprior_full(z_all, mmd_cfg.sigma,
                                           mmd_cfg.kernel,
                                           z_prior=draws["z_prior_mmd"])
        rf_w, rf_b = (rf_basis if rf_basis is not None
                      else (draws["rf_w"], draws["rf_b"]))
        mmdrf = L.wae_mmd_gaussianprior_rf(z_all, rf_w, rf_b, mmd_cfg.sigma,
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


def _make_update(model, cfgv, cfg_losses, rf_basis, optimizer, shard=None):
    """update(params, opt_state, text, beta, draws) -> metrics: one step
    at the given beta (a float, or a 0-d float32 tensor in a chunk). With
    a ``shard`` the data-parallel step: ``make_loss_fn``'s on the global
    batch, the optimizer averaging the gradients over the ranks, the
    metrics averaged too (grad_norm is global already)."""
    loss_fn = make_loss_fn(model, cfgv, cfg_losses.wae_mmd, rf_basis, shard)

    def update(params, opt_state, text, beta, draws):
        with collectives.active(shard):
            _, metrics, grads = loss_and_grads(loss_fn, params, text, beta,
                                               draws)
        with record_function("optimizer"):
            metrics["grad_norm"] = optimizer.step(params, grads, opt_state)
        if shard is not None:
            metrics = shard.mean_metrics(metrics, keep=("grad_norm",))
        metrics["beta"] = beta
        return metrics

    return update


def make_step_optimizer(cfgv, flat=False, shard=None, zero=False,
                        mesh=None):
    """The phase-1 optimizer of a step: ``make_optimizer``'s, averaging
    the gradients over ``shard``'s ranks, its clip's norm over ``mesh``'s
    parts (``dist.Mesh.global_norm``); under ``zero`` (with a shard)
    ZeRO-1's (``parallel/zero.py``), whatever ``flat`` says, as the JAX
    package's ZeRO step."""
    if zero and shard is not None:
        return ZeroAdam(cfgv.lr, cfgv.clip_grad, shard)
    return make_optimizer(cfgv, flat,
                          None if shard is None else shard.mean_,
                          None if mesh is None else mesh.global_norm)


def make_train_step(model, cfgv, cfg_losses, rf_basis, flat=False,
                    shard=None, zero=False, mesh=None):
    """train_step(params, opt_state, text, it, draws) -> metrics (0-d
    tensors on the device); updates params and opt_state in place. ``flat``
    selects the flat-vector Adam (``--hw.flat_optimizer on``); ``shard``
    (``parallel/collectives.py``) the data-parallel step, and ``zero``
    with it ZeRO-1's optimizer (``parallel/zero.py``). With ``mesh``
    (``dist.Mesh``) the tensor- and pipeline-parallel step, the JAX
    package's ``make_tp_train_step`` (and ``make_pp_model``'s step): the
    model is ``mesh.wrap``'s, the params and Adam's moments the rank's
    parts (``mesh.shard``), ``shard`` the mesh's data axis."""
    optimizer = make_step_optimizer(cfgv, flat, shard, zero, mesh)
    update = _make_update(model, cfgv, cfg_losses, rf_basis, optimizer,
                          shard)

    def train_step(params, opt_state, text, it, draws):
        return update(params, opt_state, text, anneal(cfgv.beta, it), draws)

    return train_step, optimizer


class TrainChunk(GraphChunk):
    """``unroll`` train steps, it0 .. it0 + unroll - 1, on texts [unroll,
    B, T]: the JAX package's ``make_train_scan``. Each step takes the
    draws of the per-step path (``draw_step`` with the generator of
    (seed, it)) and the beta of its own it, so the updates are those of
    ``unroll`` calls of the train step. Returns the last step's metrics.
    On the card one captured CUDA graph (``train/chunk.py``), its inputs
    the texts and the betas; on CPU tensors the steps run eagerly, and
    ``draws`` (one dict per step) may replace the generators' draws."""

    def __init__(self, model, cfgv, cfg_losses, rf_basis, unroll, seed=0,
                 flat=False, shard=None, mesh=None):
        if rf_basis is None:
            raise ValueError("a train chunk needs a fixed RF basis: under "
                             "rf_resample the loop runs unroll 1")
        super().__init__(unroll, shard)
        self.model, self.cfgv, self.seed = model, cfgv, seed
        self.optimizer = make_step_optimizer(cfgv, flat, shard, mesh=mesh)
        self._step = _make_update(model, cfgv, cfg_losses, rf_basis,
                                  self.optimizer, shard)

    def __call__(self, params, opt_state, texts, it0, draws=None):
        return self.run({"params": params, "opt": opt_state}, (texts,), it0,
                        draws)

    def stage(self, texts, it0):
        """Fill the captured graph's inputs for steps it0 .. it0 + unroll -
        1 (a measurement of the staging alone, tools/profile_train.py)."""
        self._stage(self._inputs(it0, texts), it0)

    def _inputs(self, it0, texts):
        return {"text": torch.as_tensor(texts),
                "beta": torch.tensor([anneal(self.cfgv.beta, it0 + i)
                                      for i in range(self.unroll)],
                                     dtype=torch.float32)}

    def _draws(self, it0, inputs, dev, out=None):
        B, T = inputs["text"].shape[1:]
        return [draw_step(self.model,
                          runtime.generator(dev, self.seed, it0 + i), B, T,
                          dev, out=None if out is None else out[i])
                for i in range(self.unroll)]

    def _update(self, state, x, draws):
        return self._step(state["params"], state["opt"], x["text"],
                          x["beta"], draws)


def make_train_chunk(model, cfgv, cfg_losses, rf_basis, unroll, seed=0,
                     flat=False, shard=None, mesh=None):
    """The ``TrainChunk`` of ``unroll`` steps (the JAX package's
    ``make_train_scan``; with a ``shard`` its ``make_dp_train_scan``; with
    a pipe-only ``mesh`` its scan of the ``make_pp_model`` step); its
    draws come from the generators of (seed, it)."""
    return TrainChunk(model, cfgv, cfg_losses, rf_basis, unroll, seed, flat,
                      shard, mesh)


@torch.no_grad()
def heldout_batch(model, params, text, gen=None, draws=None):
    """One heldout batch without dropout: (recon, kl, mu, logvar). A
    posterior flow decodes flow(z0) and its KL is the flow posterior's,
    as in the JAX package's heldout eval. ``draws`` may hold "eps" and
    "c_bits" (tests feed the JAX package's); the others come from
    ``gen``, eps first."""
    draws = draws or {}
    if model.flow > 0 and model.flow_mode == "posterior":
        mu, lv, _, logits, kl = flow_forward(model, params, text, False,
                                             draws, gen)
        return L.recon_dec(text, logits), kl, mu, lv
    (mu, lv), _, logits = model.forward(params, text, q_c="prior",
                                        sample_z=1, train=False, gen=gen,
                                        draws=draws)
    return L.recon_dec(text, logits), L.kl_gaussianprior(mu, lv), mu, lv


def evaluate_heldout(model, params, dataset, gen, n_batches=4,
                     iterator="hld_vae"):
    """Mean heldout recon/KL over a few val batches (``heldout_batch``),
    and the Frobenius distance of Cov_q(z) over their encodings to I.
    None when the dataset has no such iterator."""
    if iterator not in dataset._iters:
        return None
    dev = next(iter(checkpoints.flatten(params).values())).device
    recons, kls, mus, lvs = [], [], [], []
    for _ in range(n_batches):
        text = torch.from_numpy(dataset.next_batch(iterator).text).to(dev)
        recon, kl, mu, lv = heldout_batch(model, params, text, gen)
        recons.append(recon)
        kls.append(kl)
        mus.append(mu)
        lvs.append(lv)
    C, _, _ = cov_q(torch.cat(mus), torch.cat(lvs))
    return {"recon": torch.stack(recons).mean().item(),
            "kl": torch.stack(kls).mean().item(),
            "cov_frob": frobenius_to_identity(C)}


def train_vae(cfg, model, dataset, params, logger=None, on_checkpoint=None):
    """Run the phase-1 loop on the device the params live on. Updates
    params in place; returns (params, opt_state, steps_per_sec), the rate
    over the whole loop (the rate from the first step or chunk boundary at
    or after WARM_STEPS is logged as train_steps_per_sec_warm). Under
    tensor or pipeline parallelism the params and state returned are the
    full trees gathered from the ranks."""
    cfgv = cfg.vae
    dev = next(iter(checkpoints.flatten(params).values())).device
    mmd_cfg = cfg.losses.wae_mmd
    rf_basis = None
    if not mmd_cfg.rf_resample:
        rf_basis = L.init_rf_basis(
            runtime.generator(dev, cfg.seed, _RF_STREAM), model.z_dim,
            mmd_cfg.rf_dim, dev)
    flat = C.flat_optimizer_enabled(cfg)
    # a process group selects the parallel step: under hw.tp or hw.pp the
    # JAX package's make_tp_train_step / make_pp_model step over a mesh,
    # else its make_dp_train_step (with hw.zero make_zero_train_step)
    mesh, shard = pdist.parallel_layout(cfg, [cfgv.batch_size])
    zero = (mesh is None and shard is not None
            and bool(cfg.hw.get("zero", False)))
    writer = pdist.is_writer()
    plain_model = model
    if mesh is not None:
        if flat:
            raise ValueError(FLAT_UNDER_MP)
        model = mesh.wrap(model)
        log.info("model-parallel training over %r%s", mesh,
                 "; hw.zero is not applied under hw.tp / hw.pp (the JAX "
                 "package takes their branch first)"
                 if cfg.hw.get("zero", False) else "")
    elif shard is not None:
        log.info("data-parallel training over %d ranks (%s)%s",
                 shard.world, shard.backend,
                 " (ZeRO-1 sharded optimizer state)" if zero else "")
    train_step, optimizer = make_train_step(model, cfgv, cfg.losses,
                                            rf_basis, flat, shard, zero, mesh)
    opt_state = optimizer.init(params)
    if cfg.loadpath:
        # every rank reads the file; ZeRO-1 keeps its segments of the
        # per-leaf moments the file holds, a mesh rank its parts
        tmpl = (optimizer.full_state(params, opt_state) if zero
                else opt_state)
        params, opt_state = checkpoints.load_train_state(
            cfg.loadpath, params, tmpl, dev, c_args=cfg.model.C_args)
        if zero:
            opt_state = optimizer.from_full(params, opt_state)
        log.info("Loaded train state from %s", cfg.loadpath)
    if mesh is not None:
        params, opt_state = mesh.shard(params), mesh.shard_opt(opt_state)
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
        save = expsv and it > cfgv.s_iter
        full, saved_opt = params, opt_state
        if save and zero:
            # every rank's segments, gathered by all of them
            saved_opt = optimizer.full_state(params, opt_state)
        if mesh is not None and (cheap or expsv):
            # the full trees from every rank's parts, gathered by all
            full = mesh.gather(params)
            if save:
                saved_opt = mesh.gather_opt(opt_state)
        hld = None
        if save and cfg.hw.get("heldout_eval", True) and (
                writer or mesh is not None):
            # on a mesh every rank runs its part of the heldout passes
            with tracing.span("train.heldout", it=it):
                hld = evaluate_heldout(
                    model, params, dataset,
                    runtime.generator(dev, cfg.seed, _HELDOUT_STREAM, it))
        if not writer:
            return
        if cheap or expsv:
            with tracing.span("train.sample", it=it):
                sent, _, _ = generate_sentences(
                    plain_model, full, 1,
                    gen=runtime.generator(dev, cfg.seed, _LOG_STREAM, it),
                    sample_mode="categorical", device=dev)
            fetch.add(it, metrics, sent, force=expsv)
        if save:
            path = cfgv.chkpt_path.format(it)
            with tracing.span("train.save", it=it):
                checkpoints.save(path, full, saved_opt, step=it,
                                 c_args=cfg.model.C_args)
            log.info("Saved model to %s", path)
            if hld is not None:
                if logger is not None:
                    for k, v in hld.items():
                        logger.log_value("hld_" + k, v, it)
                log.info("HELDOUT recon: %.4f kl: %.4f", hld["recon"],
                         hld["kl"])
            if on_checkpoint is not None:
                on_checkpoint(it, full)

    def needs_host(j):
        return j % cfgv.cheaplog_every == 0 or j % cfgv.expsvlog_every == 0

    # runs of `unroll` steps as one chunk, aligned to the log cadences;
    # per-step RF bases (rf_resample), ZeRO-1 and tensor parallelism keep
    # every step eager, as in JAX (it has no scan builder for any of them)
    unroll = aligned_unroll(int(cfg.hw.get("unroll", 1) or 1),
                            int(cfgv.cheaplog_every),
                            int(cfgv.expsvlog_every))
    if mesh is not None and mesh.tp > 1:
        unroll = 1
    chunk = None
    if unroll > 1 and rf_basis is not None and not zero:
        check_chunk(mesh or shard, dev, unroll)
        chunk = make_train_chunk(model, cfgv, cfg.losses, rf_basis, unroll,
                                 cfg.seed, flat, shard, mesh)

    log.info("Training base vae ...")
    it, end_it = cfgv.s_iter, cfgv.s_iter + cfgv.n_iter
    warm_it, t_warm = None, None
    t_start = time.perf_counter()
    B, T = cfgv.batch_size, cfg.max_seq_len
    # the chunks' host work: the loader's batches and the boundary's
    # (do_host), a count and seconds each
    loader = tracing.counter("train.loader")
    boundary = tracing.counter("train.boundary")
    # a torch.profiler trace of a window of the loop's boundaries under
    # hw.profile_dir (the JAX package's jax.profiler trace)
    with tracing.trace(cfg.hw.get("profile_dir", "")) as profiler_step:
        while it <= end_it:
            if warm_it is None and it >= cfgv.s_iter + WARM_STEPS:
                # the first step (or chunk boundary) at or after WARM_STEPS
                runtime.synchronize(dev)
                warm_it, t_warm = it, time.perf_counter()
            # a chunk whenever no step inside it needs the host except
            # possibly its last; the batches and draws are the same either
            # way
            if chunk is not None and it + unroll - 1 <= end_it and not any(
                    needs_host(it + j) for j in range(unroll - 1)):
                with tracing.span("train.loader", loader, it=it):
                    texts = np.stack([dataset.next_batch("train_vae").text
                                      for _ in range(unroll)])
                metrics = chunk(params, opt_state, texts, it)
                it += unroll
                with tracing.span("train.boundary", boundary, it=it - 1):
                    do_host(it - 1, metrics)
                profiler_step()
                continue
            with tracing.span("train.loader", it=it):
                text = torch.from_numpy(
                    dataset.next_batch("train_vae").text).to(dev)
            draws = draw_step(model, runtime.generator(dev, cfg.seed, it), B,
                              T, dev, None if rf_basis is not None
                              else mmd_cfg.rf_dim)
            metrics = train_step(params, opt_state, text, it, draws)
            with tracing.span("train.boundary", it=it):
                do_host(it, metrics)
            it += 1
            profiler_step()
        fetch.flush()
        runtime.synchronize(dev)
    t_end = time.perf_counter()
    steps_per_sec = (cfgv.n_iter + 1) / max(t_end - t_start, 1e-9)
    if chunk is not None and chunk.node_kinds is not None:
        log.info(chunk.summary())
        log.info("CUDA graph %s", json.dumps(chunk.stats()))
    if logger is not None:
        logger.log_value("train_steps_per_sec", steps_per_sec, end_it)
        if warm_it is not None:
            logger.log_value("train_steps_per_sec_warm",
                             (end_it + 1 - warm_it)
                             / max(t_end - t_warm, 1e-9), end_it)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(False)
    if mesh is not None:
        params, opt_state = mesh.gather(params), mesh.gather_opt(opt_state)
    return params, opt_state, steps_per_sec


FLAT_UNDER_MP = (
    "--hw.flat_optimizer on under hw.tp or hw.pp > 1: the flat Adam ravels "
    "whole leaves, and a tensor- or pipeline-parallel rank holds parts of "
    "them; train with --hw.flat_optimizer off (the JAX package's TP and PP "
    "steps run the per-leaf optax Adam too)")
