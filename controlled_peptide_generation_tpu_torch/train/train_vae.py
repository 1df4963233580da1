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
"""

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
    yet (ROADMAP.md A9); flows raise where the model is built."""
    hw = cfg.hw
    for name in ("dp", "tp", "pp"):
        if int(hw.get(name, 1) or 1) > 1:
            raise NotImplementedError(
                f"hw.{name} > 1 is not ported (ROADMAP.md A9)")
    if int(hw.get("dp", 1)) == 0:
        raise NotImplementedError("hw.dp 0 (all devices) is not ported "
                                  "(ROADMAP.md A9)")
    if hw.get("zero", False):
        raise NotImplementedError("hw.zero is not ported (ROADMAP.md A9)")
    if hw.get("profile_dir", ""):
        raise NotImplementedError("hw.profile_dir is not ported")


def aligned_unroll(unroll, *cadences):
    """Largest chunk width <= unroll that divides every log cadence (the
    JAX package's ``aligned_unroll``): chunks then end on the host's
    boundaries instead of straddling them."""
    g = math.gcd(*cadences)
    for d in range(min(unroll, g), 0, -1):
        if g % d == 0:
            return d
    return 1


class _Drawer:
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

    def below(self, name, shape, p, i=None):
        """A bool mask, True where a uniform draw is below p."""
        u = torch.empty(shape, device=self.device).uniform_(
            generator=self.gen)
        if self.out is None:
            return u < p
        return torch.lt(u, p, out=self._into(name, i, shape, torch.bool))


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
    d = _Drawer(gen, device, out)
    draws = {
        "eps": d.normal("eps", (B, Z)),
        "c_bits": d.below("c_bits", (B,), 0.5),
        "word_drop": d.below("word_drop", (B, T), p_wd),
    }
    if not tfm_dec:
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


def _make_update(model, cfgv, cfg_losses, rf_basis, optimizer):
    """update(params, opt_state, text, beta, draws) -> metrics: one step
    at the given beta (a float, or a 0-d float32 tensor in a chunk)."""
    loss_fn = make_loss_fn(model, cfgv, cfg_losses.wae_mmd, rf_basis)

    def update(params, opt_state, text, beta, draws):
        _, metrics, grads = loss_and_grads(loss_fn, params, text, beta,
                                           draws)
        with record_function("optimizer"):
            metrics["grad_norm"] = optimizer.step(params, grads, opt_state)
        metrics["beta"] = beta
        return metrics

    return update


def make_train_step(model, cfgv, cfg_losses, rf_basis, flat=False):
    """train_step(params, opt_state, text, it, draws) -> metrics (0-d
    tensors on the device); updates params and opt_state in place. ``flat``
    selects the flat-vector Adam (``--hw.flat_optimizer on``)."""
    optimizer = make_optimizer(cfgv, flat)
    update = _make_update(model, cfgv, cfg_losses, rf_basis, optimizer)

    def train_step(params, opt_state, text, it, draws):
        return update(params, opt_state, text, anneal(cfgv.beta, it), draws)

    return train_step, optimizer


def launch_counters():
    """The train step's kernel wrappers, whose ``launches`` counts a
    replay of a chunk's graph cannot reach (the chunk adds them)."""
    from ..ops import gru_fwd_kernel, gru_kernel, mmd_kernel
    return (gru_kernel.gru_seq_fwd, gru_kernel.gru_seq_bwd,
            gru_kernel.gru_seq_wgrad, gru_fwd_kernel.gru_fwd,
            mmd_kernel.mmd_full_fwd, mmd_kernel.mmd_full_bwd)


class TrainChunk:
    """``unroll`` train steps, it0 .. it0 + unroll - 1, on texts [unroll,
    B, T]: the JAX package's ``make_train_scan``. Each step takes the
    draws of the per-step path (``draw_step`` with the generator of
    (seed, it)) and the beta of its own it, so the updates are those of
    ``unroll`` calls of the train step. Returns the last step's metrics.

    On CUDA tensors the steps are one CUDA graph, captured on the first
    call and replayed on every later one. Its inputs are static buffers
    filled before each replay: the texts and the betas by one copy each
    from pinned host buffers, every step's draws drawn into theirs by the
    per-step generators. The graph holds the addresses of the params and
    the optimizer state, so a call with other tensors raises. Before the
    capture two steps run on copies of the state on the capture stream,
    so the libraries, the kernels' set-up and B5's completion counter for
    that stream exist and the trajectory does not move. The launch
    counters skip that set-up and the capture; each replay adds the
    launches the capture made. A capture that fails raises. On CPU tensors
    the steps run eagerly, and ``draws`` (one dict per step) may replace
    the generators' draws, as tests feed the JAX package's."""

    def __init__(self, model, cfgv, cfg_losses, rf_basis, unroll, seed=0,
                 flat=False):
        if rf_basis is None:
            raise ValueError("a train chunk needs a fixed RF basis: under "
                             "rf_resample the loop runs unroll 1")
        self.model, self.cfgv, self.unroll, self.seed = (
            model, cfgv, int(unroll), seed)
        self.optimizer = make_optimizer(cfgv, flat)
        self._update = _make_update(model, cfgv, cfg_losses, rf_basis,
                                    self.optimizer)
        self.graph = None
        self.node_kinds = None     # the captured graph's node kinds
        self.captured = {}         # launches per replay, by counter
        self.replays = 0

    def _betas(self, it0):
        return torch.tensor([anneal(self.cfgv.beta, it0 + i)
                             for i in range(self.unroll)],
                            dtype=torch.float32)

    def _draws(self, it0, B, T, dev, out=None):
        return [draw_step(self.model,
                          runtime.generator(dev, self.seed, it0 + i), B, T,
                          dev, out=None if out is None else out[i])
                for i in range(self.unroll)]

    def __call__(self, params, opt_state, texts, it0, draws=None):
        texts = torch.as_tensor(texts)
        if texts.shape[0] != self.unroll:
            raise ValueError(f"{texts.shape[0]} batches for a chunk of "
                             f"{self.unroll}")
        dev = next(iter(checkpoints.flatten(params).values())).device
        if dev.type == "cuda":
            if draws is not None:
                raise ValueError("a chunk on the card draws its own: "
                                 "injected draws run on CPU tensors")
            return self._replay(params, opt_state, texts, it0, dev)
        texts, betas = texts.to(dev), self._betas(it0)
        if draws is None:
            draws = self._draws(it0, *texts.shape[1:], dev)
        for i in range(self.unroll):
            metrics = self._update(params, opt_state, texts[i], betas[i],
                                   draws[i])
        return metrics

    def _state_ptrs(self, params, opt_state):
        return [t.data_ptr() for t in checkpoints.flatten(
            {"params": params, "opt": opt_state}).values()]

    def stage(self, texts, it0):
        """Fill the captured graph's inputs for steps it0 .. it0 + unroll -
        1: the texts [unroll, B, T] and the betas (one copy each from the
        pinned host buffers, once the last stage's copies are done), and
        every step's draws from the per-step generators."""
        with record_function("chunk stage"):
            texts = torch.as_tensor(texts)
            self._copied.synchronize()
            self._host_texts.copy_(texts)
            self._host_betas.copy_(self._betas(it0))
            self._texts.copy_(self._host_texts, non_blocking=True)
            self._betas_dev.copy_(self._host_betas, non_blocking=True)
            self._copied.record()
            self._draws(it0, *texts.shape[1:], self._texts.device,
                        out=self._static_draws)

    def _replay(self, params, opt_state, texts, it0, dev):
        if self.graph is None:
            self._capture(params, opt_state, texts, it0, dev)
        elif self._ptrs != self._state_ptrs(params, opt_state):
            raise ValueError("the chunk's graph was captured on other "
                             "params or optimizer state tensors")
        else:
            self.stage(texts, it0)
        with record_function("chunk replay"):
            self.graph.replay()
        self.replays += 1
        for fn, n in self.captured.items():
            fn.launches += n
        return dict(zip(self._keys, self._packed.clone().unbind(0)))

    def _capture(self, params, opt_state, texts, it0, dev):
        counters = launch_counters()
        counts = [fn.launches for fn in counters]
        self._texts = torch.empty(texts.shape, dtype=texts.dtype, device=dev)
        self._betas_dev = torch.empty((self.unroll,), device=dev)
        self._host_texts = torch.empty(texts.shape, dtype=texts.dtype,
                                       pin_memory=True)
        self._host_betas = torch.empty((self.unroll,), pin_memory=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        self._static_draws = self._draws(it0, *texts.shape[1:], dev)
        self.stage(texts, it0)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            copies = checkpoints.unflatten({
                p: t.detach().clone().requires_grad_(t.requires_grad)
                for p, t in checkpoints.flatten(params).items()})
            opt_copy = checkpoints.unflatten({
                p: t.clone() for p, t in
                checkpoints.flatten(opt_state).items()})
            for i in range(2):
                self._update(copies, opt_copy, self._texts[i % self.unroll],
                             self._betas_dev[i % self.unroll],
                             self._static_draws[i % self.unroll])
        torch.cuda.current_stream(dev).wait_stream(stream)
        del copies, opt_copy
        for fn, n in zip(counters, counts):
            fn.launches = n
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream):
            for i in range(self.unroll):
                metrics = self._update(params, opt_state, self._texts[i],
                                       self._betas_dev[i],
                                       self._static_draws[i])
            self._keys = sorted(metrics)
            self._packed = torch.stack([metrics[k] for k in self._keys])
        self.captured = {fn: fn.launches - n
                         for fn, n in zip(counters, counts)
                         if fn.launches != n}
        for fn, n in zip(counters, counts):
            fn.launches = n
        self.node_kinds = runtime.graph_node_kinds(graph.raw_cuda_graph())
        graph.instantiate()
        self.graph = graph
        self._ptrs = self._state_ptrs(params, opt_state)


def make_train_chunk(model, cfgv, cfg_losses, rf_basis, unroll, seed=0,
                     flat=False):
    """The ``TrainChunk`` of ``unroll`` steps (the JAX package's
    ``make_train_scan``); its draws come from the generators of (seed,
    it)."""
    return TrainChunk(model, cfgv, cfg_losses, rf_basis, unroll, seed, flat)


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
    C, _, _ = cov_q(torch.cat(mus), torch.cat(lvs))
    return {"recon": torch.stack(recons).mean().item(),
            "kl": torch.stack(kls).mean().item(),
            "cov_frob": frobenius_to_identity(C)}


def train_vae(cfg, model, dataset, params, logger=None, on_checkpoint=None):
    """Run the phase-1 loop on the device the params live on. Updates
    params in place; returns (params, opt_state, steps_per_sec), the rate
    over the whole loop (the rate from the first step or chunk boundary at
    or after WARM_STEPS is logged as train_steps_per_sec_warm)."""
    check_supported(cfg)
    cfgv = cfg.vae
    dev = next(iter(checkpoints.flatten(params).values())).device
    mmd_cfg = cfg.losses.wae_mmd
    rf_basis = None
    if not mmd_cfg.rf_resample:
        rf_basis = L.init_rf_basis(
            runtime.generator(dev, cfg.seed, _RF_STREAM), model.z_dim,
            mmd_cfg.rf_dim, dev)
    flat = C.flat_optimizer_enabled(cfg)
    train_step, optimizer = make_train_step(model, cfgv, cfg.losses,
                                            rf_basis, flat)
    opt_state = optimizer.init(params)
    if cfg.loadpath:
        params, opt_state = checkpoints.load_train_state(
            cfg.loadpath, params, opt_state, dev, c_args=cfg.model.C_args)
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
            checkpoints.save(path, params, opt_state, step=it,
                             c_args=cfg.model.C_args)
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

    def needs_host(j):
        return j % cfgv.cheaplog_every == 0 or j % cfgv.expsvlog_every == 0

    # runs of `unroll` steps as one chunk, aligned to the log cadences;
    # per-step RF bases (rf_resample) keep every step eager, as in JAX
    unroll = aligned_unroll(int(cfg.hw.get("unroll", 1) or 1),
                            int(cfgv.cheaplog_every),
                            int(cfgv.expsvlog_every))
    chunk = None
    if unroll > 1 and rf_basis is not None:
        chunk = make_train_chunk(model, cfgv, cfg.losses, rf_basis, unroll,
                                 cfg.seed, flat)

    log.info("Training base vae ...")
    it, end_it = cfgv.s_iter, cfgv.s_iter + cfgv.n_iter
    warm_it, t_warm = None, None
    t_start = time.perf_counter()
    B, T = cfgv.batch_size, cfg.max_seq_len
    while it <= end_it:
        if warm_it is None and it >= cfgv.s_iter + WARM_STEPS:
            # the first step (or chunk boundary) at or after WARM_STEPS
            runtime.synchronize(dev)
            warm_it, t_warm = it, time.perf_counter()
        # a chunk whenever no step inside it needs the host except
        # possibly its last; the batches and draws are the same either way
        if chunk is not None and it + unroll - 1 <= end_it and not any(
                needs_host(it + j) for j in range(unroll - 1)):
            texts = np.stack([dataset.next_batch("train_vae").text
                              for _ in range(unroll)])
            metrics = chunk(params, opt_state, texts, it)
            it += unroll
            do_host(it - 1, metrics)
            continue
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
    if chunk is not None and chunk.node_kinds is not None:
        log.info("%d replays of a %d-step CUDA graph of %d kernel nodes",
                 chunk.replays, unroll, chunk.node_kinds.count("kernel"))
    if logger is not None:
        logger.log_value("train_steps_per_sec", steps_per_sec, end_it)
        if warm_it is not None:
            logger.log_value("train_steps_per_sec_warm",
                             (end_it + 1 - warm_it)
                             / max(t_end - t_warm, 1e-9), end_it)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(False)
    return params, opt_state, steps_per_sec
