"""Phase-2 controlled-generation training on one device (the JAX package's
``train/train_full.py``, after Hu et al. 2017, "Toward Controlled
Generation of Text"), for any pairing of the GRU and transformer
families.

Each iteration runs three sub-updates, each its own loss, gradient and
clipped Adam:

1. the VAE update (``vae_loss``): recon + beta * z_regu + the logvar
   penalties, with c = softmax of the classifier on the batch; its
   gradients step opt_E (lrE; ``emb`` and ``enc``) and opt_G (lrG;
   ``dec``);
2. the generator's attribute update (``g_attr_loss``), from the params
   after (1): sentences soft-sampled from (z, c) of the priors (the soft
   mode of ``G_soft_sample_kwargs``, the annealed softmax temperature),
   lambda_c * CE(classifier(soft), c) + lambda_z * ||encode(soft).mu -
   z||^2 with the encoder in eval mode; it steps opt_G again, so opt_G
   counts two steps an iteration;
3. the classifier update (``c_loss``, lrC; ``clf``): CE on a labelled
   batch under the classifier's dropout, + lambda_u * (CE on hard samples
   of the prior (``C_hard_sample_kwargs``), without gradient, against
   their c, + lambda_e * the classifier's entropy on them).

Each optimizer owns its group alone, which equals the JAX package's masked
update over the whole tree: zero gradients with zero moments give a zero
update, and the global norm of the clip runs over the group. On the card
the GRU family's recurrences run B2 (three in the VAE update, two in
``encode(soft)``, whose input gradient carries the attribute loss back
into the soft sampler), and B5 under ``--full.z_regu_loss mmd``; the
mmdrf term, logged as ``L_wae_mmdrf``, is computed every step (the JAX
loss computes the full MMD too, unused unless it regularizes).

Every random draw of an iteration comes from ``draw_full_step`` with the
generator of (seed, stream, it) and can be handed in (tests feed the JAX
package's).

``--hw.unroll`` (default 50) is the JAX package's ``make_full_scan``: the
loop takes each run of ``aligned_unroll`` iterations that needs no host
work before its last one as one ``FullChunk``, on the card one captured
CUDA graph of the whole run (all three sub-updates of every iteration, B2
and B5 inside it), replayed after its inputs (the batches, the betas and
softmax temperatures, every iteration's draws) are staged; on the CPU the
same iterations run eagerly. The updates are the per-step path's: beta
and the temperature reach both paths as 0-d device tensors.
``--hw.unroll 1`` runs every iteration eagerly.

Under a process group the loop is the JAX package's data-parallel phase 2
(``make_dp_full_step``, ``make_dp_full_scan``): every rank draws the
iteration's global draws and reads the global batches, runs its rows
through each sub-loss (the VAE's z gathered for its WAE terms, the
attribute and classifier stages on their rows of the prior draws), and
each optimizer averages its group's gradients over the ranks before its
clip (``parallel/collectives.py``); under NCCL a chunk's CUDA graph holds
those collectives. Rank 0 alone writes logs and checkpoints.

Under ``hw.tp`` or ``hw.pp`` > 1 (a ``dist.Mesh``) the loop is the JAX
package's ``make_tp_full_step`` over a 2D or 3D mesh, or its
``make_pp_model`` step (``train/train_full.py:195-262`` there): the
transformer legs run each rank's part, each optimizer steps its group's
slices with the global norm over the mesh, and the soft and hard
samplers read the decoder's blocks gathered in full
(``Mesh.gather(..., grad=True)``); checkpoints hold the full tree. Under
TP every iteration is eager, as in JAX.
"""

import json
import logging
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import losses as L
from ..ops import sampling
from ..parallel import collectives, dist as pdist
from ..utils import runtime
from ..utils.annealing import anneal
from ..utils.logging import DeferredFetch
from . import checkpoints
from .chunk import GraphChunk
from .opt import ClipAdam
from .train_vae import (ROW_DRAWS, WARM_STEPS, Drawer, aligned_unroll,
                        check_chunk, draw_step)

log = logging.getLogger(__name__)

# generator streams of phase 2, keyed (seed, stream, it)
_RF_STREAM, _CLF_STREAM, _STEP_STREAM = 4, 5, 6
# the optimizer groups: opt_E, opt_G, opt_C and the trees each updates
GROUPS = {"E": ("emb", "enc", "flow"), "G": ("dec",), "C": ("clf",)}
# the row dim of each attribute and classifier draw (the Gumbel noise is
# [T, n, V]): a data-parallel rank takes its rows of them
PRIOR_ROWS = {"z": 0, "c_bits": 0, "keep": 0, "noise": 1}


def group(params, name):
    """The subtrees of ``params`` that optimizer ``name`` updates."""
    return {k: params[k] for k in GROUPS[name] if k in params}


def draw_full_step(model, gen, B, B_lab, T, device, cfgf, out=None):
    """Every random draw of one phase-2 iteration, in three dicts:

    * "vae": ``draw_step``'s (eps, word_drop, the decoder's and encoder's
      dropout masks, z_prior_mmd, z_prior_rf; its c_bits go unused, c
      comes from the classifier);
    * "attr": z [B, Z] and c_bits [B] of the priors, and under
      categorical_softmax the Gumbel noise [T, B, V];
    * "clf": keep [B_lab, num_filters * n_widths] (the classifier's
      dropout mask), z [B_lab, Z], c_bits [B_lab] and the hard sample's
      noise [T, B_lab, V] when its mode is categorical.

    With ``out`` (the dicts of an earlier call at the same shapes) the
    draws are written into its tensors, bit for bit the same."""
    c_args = model.C_args
    n_feats = c_args.get("num_filters", 100) * (
        c_args.get("max_filter_width", 5) - c_args.get("min_filter_width", 3)
        + 1)
    p_keep = 1.0 - c_args.get("dropout", 0.5)
    V, Z = model.n_vocab, model.z_dim
    draws = {"vae": draw_step(model, gen, B, T, device,
                              out=None if out is None else out["vae"])}
    for name, n, mode, with_keep in (
            ("attr", B, _soft_mode(cfgf), False),
            ("clf", B_lab, _hard_mode(cfgf), True)):
        d = Drawer(gen, device, None if out is None else out[name])
        drawn = {}
        if with_keep:
            drawn["keep"] = d.below("keep", (n, n_feats), p_keep)
        drawn["z"] = d.normal("z", (n, Z))
        drawn["c_bits"] = d.below("c_bits", (n,), 0.5)
        if mode in ("categorical", "categorical_softmax"):
            drawn["noise"] = d.gumbel("noise", (T, n, V))
        draws[name] = drawn
    return draws


def _soft_mode(cfgf):
    mode = cfgf.G_soft_sample_kwargs.get("sample_mode", "none_softmax")
    if mode not in sampling.SOFT_MODES:
        raise ValueError(f"G_soft_sample_kwargs.sample_mode {mode!r} is not "
                         f"one of {sampling.SOFT_MODES}")
    return mode


def _hard_mode(cfgf):
    mode = cfgf.C_hard_sample_kwargs.get("sample_mode", "categorical")
    if mode not in sampling.HARD_MODES:
        raise ValueError(f"C_hard_sample_kwargs.sample_mode {mode!r} is not "
                         f"one of {sampling.HARD_MODES}")
    return mode


def _ce(logits, target):
    """Mean cross-entropy of logits [B, 2] against int targets [B]."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, target.long()[:, None]).mean()


def make_full_losses(model, cfgf, mmd_cfg, rf_basis, shard=None, mesh=None):
    """The three phase-2 objectives, each -> (loss, metrics):
    vae_loss(params, text, beta, draws), g_attr_loss(params, temp, draws)
    and c_loss(params, lab_text, lab_y, temp, draws), ``draws`` the
    matching dict of ``draw_full_step``. rf_basis: (rf_w, rf_b). With a
    ``shard`` the batches and draws are global and the rank's rows run
    each loss, the VAE's WAE terms on the gathered z. With a ``mesh``
    (``dist.Mesh``) the params are the rank's parts, and the samplers'
    cached decode steps read the decoder gathered in full."""
    soft_mode, hard_mode = _soft_mode(cfgf), _hard_mode(cfgf)
    rf_w, rf_b = rf_basis

    def decoding(params):
        """The params the cached decode steps read: the decoder whole."""
        if mesh is None:
            return params
        return dict(params, **mesh.gather({"dec": params["dec"]},
                                          grad=True))

    def rows(draws, dims, *batches):
        if shard is None:
            return (draws,) + batches
        return (shard.rows_of(draws, dims),) + tuple(
            shard.rows(b) for b in batches)

    def vae_loss(params, text, beta, draws):
        count = None if shard is None else L.token_count(text) / shard.world
        draws, text = rows(draws, ROW_DRAWS, text)
        (mu, logvar), (z, _), dec_logits = model.forward(
            params, text, q_c="classifier", sample_z=1, train=True,
            draws=draws)
        recon = L.recon_dec(text, dec_logits, count)
        kl = L.kl_gaussianprior(mu, logvar)
        z_all = z if shard is None else shard.gather(z)
        mmdrf = L.wae_mmd_gaussianprior_rf(z_all, rf_w, rf_b, mmd_cfg.sigma,
                                           z_prior=draws["z_prior_rf"])
        if cfgf.z_regu_loss == "mmd":
            z_regu = L.wae_mmd_gaussianprior_full(
                z_all, mmd_cfg.sigma, mmd_cfg.kernel,
                z_prior=draws["z_prior_mmd"])
        else:
            z_regu = {"kl": kl, "mmdrf": mmdrf}[cfgf.z_regu_loss]
        loss = (recon + beta * z_regu
                + cfgf.lambda_logvar_L1 * logvar.abs().sum(1).mean()
                + cfgf.lambda_logvar_KL * L.kl_gaussian_sharedmu(mu, logvar))
        return loss, {"L_vae": loss, "L_vae_recon": recon, "L_vae_kl": kl,
                      "L_wae_mmdrf": mmdrf}

    def g_attr_loss(params, temp, draws):
        draws, = rows(draws, PRIOR_ROWS)
        z = draws["z"]
        c = model.c_from_bits(draws["c_bits"])
        _, soft = sampling.sample_sentences(
            model, decoding(params), z, c, sample_mode=soft_mode, temp=temp,
            noise=draws.get("noise"))
        attr_c = _ce(model.classify(params, soft), draws["c_bits"])
        mu_hat, _ = model.encode(params, soft)
        attr_z = ((mu_hat - z) ** 2).sum(1).mean()
        loss = cfgf.lambda_c * attr_c + cfgf.lambda_z * attr_z
        return loss, {"L_attr_c": attr_c, "L_attr_z": attr_z}

    def c_loss(params, lab_text, lab_y, temp, draws):
        draws, lab_text, lab_y = rows(draws, PRIOR_ROWS, lab_text, lab_y)
        logits_s = model.classify(params, lab_text, train=True,
                                  keep=draws["keep"])
        sup = _ce(logits_s, lab_y)
        gen = sampling.sample_sentences(
            model, decoding(params), draws["z"],
            model.c_from_bits(draws["c_bits"]),
            sample_mode=hard_mode, temp=temp, noise=draws.get("noise"))
        logp_u = torch.log_softmax(model.classify(params, gen), dim=1)
        unsup = -torch.gather(logp_u, 1,
                              draws["c_bits"].long()[:, None]).mean()
        ent = -(logp_u.exp() * logp_u).sum(1).mean()
        loss = sup + cfgf.lambda_u * (unsup + cfgf.lambda_e * ent)
        acc = (logits_s.argmax(1) == lab_y.long()).float().mean()
        return loss, {"L_clf_sup": sup, "L_clf_unsup": unsup,
                      "clf_entropy": ent, "clf_acc": acc}

    return vae_loss, g_attr_loss, c_loss


def group_grads(loss, params, names):
    """{name: gradients nested like group(params, name)} of ``loss``, one
    backward for all the names."""
    flat = {n: checkpoints.flatten(group(params, n)) for n in names}
    grads = iter(torch.autograd.grad(
        loss, [t for n in names for t in flat[n].values()]))
    return {n: checkpoints.unflatten({p: next(grads) for p in flat[n]})
            for n in names}


class FullStep:
    """One phase-2 iteration: step(params, opt_states, text, lab_text,
    lab_y, it, draws) -> metrics (0-d tensors on the device, and beta and
    softmax_temp); updates params and the three optimizer states in place.
    ``opt_states`` is ``init(params)``: {"E", "G", "C"}, each a ClipAdam
    state over its group. With a ``shard`` the data-parallel iteration
    (the JAX package's ``make_dp_full_step``): each optimizer averages
    its group's gradients over the ranks, and the metrics are averaged.
    With a ``mesh`` (``dist.Mesh``, the model ``mesh.wrap``'s and the
    params the rank's parts) the JAX package's ``make_tp_full_step``:
    each optimizer's clip takes the global norm over the mesh."""

    def __init__(self, model, cfgf, cfg_losses, rf_basis, shard=None,
                 mesh=None):
        self.cfgf, self.shard = cfgf, shard
        self.vae_loss, self.g_attr_loss, self.c_loss = make_full_losses(
            model, cfgf, cfg_losses.wae_mmd, rf_basis, shard, mesh)
        kw = {"reduce": None if shard is None else shard.mean_,
              "norm": None if mesh is None else mesh.global_norm}
        self.opts = {"E": ClipAdam(cfgf.lrE, cfgf.clip_grad, **kw),
                     "G": ClipAdam(cfgf.lrG, cfgf.clip_grad, **kw),
                     "C": ClipAdam(cfgf.lrC, cfgf.clip_grad, **kw)}

    def init(self, params):
        return {n: opt.init(group(params, n)) for n, opt in self.opts.items()}

    def _update(self, params, opt_states, loss, names):
        grads = group_grads(loss, params, names)
        with record_function("optimizer"):
            for n in names:
                self.opts[n].step(group(params, n), grads[n], opt_states[n])

    def schedule(self, it):
        """(beta, softmax_temp) of iteration ``it``, Python floats."""
        return (anneal(self.cfgf.beta, it),
                anneal(self.cfgf.softmax_temp, it))

    def __call__(self, params, opt_states, text, lab_text, lab_y, it, draws):
        beta, temp = (torch.full((), v, device=text.device)
                      for v in self.schedule(it))
        return self.update(params, opt_states, text, lab_text, lab_y, beta,
                           temp, draws)

    def update(self, params, opt_states, text, lab_text, lab_y, beta, temp,
               draws):
        """One iteration at ``beta`` and ``temp``, 0-d float32 tensors on
        the device (the per-step path fills them, a chunk's graph reads
        them from its staged inputs: the same arithmetic either way)."""
        with record_function("vae update"), collectives.active(self.shard):
            loss, m1 = self.vae_loss(params, text, beta, draws["vae"])
            self._update(params, opt_states, loss, ("E", "G"))
        with record_function("attribute update"):
            loss, m2 = self.g_attr_loss(params, temp, draws["attr"])
            self._update(params, opt_states, loss, ("G",))
        with record_function("classifier update"):
            loss, m3 = self.c_loss(params, lab_text, lab_y, temp,
                                   draws["clf"])
            self._update(params, opt_states, loss, ("C",))
        metrics = {k: v.detach() for k, v in {**m1, **m2, **m3}.items()}
        if self.shard is not None:
            metrics = self.shard.mean_metrics(metrics)
        metrics.update(beta=beta, softmax_temp=temp)
        return metrics


class FullChunk(GraphChunk):
    """``unroll`` phase-2 iterations, it0 .. it0 + unroll - 1, on texts
    [unroll, B, T], labelled texts [unroll, B_lab, T] and their labels
    [unroll, B_lab]: the JAX package's ``make_full_scan``. Each iteration
    takes the draws of the per-step path (``draw_full_step`` with the
    generator of (seed, _STEP_STREAM, it)) and the beta and softmax
    temperature of its own it, so the updates are those of ``unroll``
    calls of ``FullStep``. Returns the last iteration's metrics. On the
    card one captured CUDA graph of all three sub-updates of every
    iteration (``train/chunk.py``), its inputs the batches and the two
    schedules; on CPU tensors the iterations run eagerly, and ``draws``
    (one dict of ``draw_full_step`` per iteration) may replace the
    generators' draws."""

    def __init__(self, model, cfgf, cfg_losses, rf_basis, unroll, seed=0,
                 shard=None, mesh=None):
        super().__init__(unroll, shard)
        self.model, self.cfgf, self.seed = model, cfgf, seed
        self.step = FullStep(model, cfgf, cfg_losses, rf_basis, shard, mesh)

    def __call__(self, params, opt_states, texts, lab_texts, lab_ys, it0,
                 draws=None):
        return self.run({"params": params, "opt": opt_states},
                        (texts, lab_texts, lab_ys), it0, draws)

    def stage(self, texts, lab_texts, lab_ys, it0):
        """Fill the captured graph's inputs for iterations it0 .. it0 +
        unroll - 1 (a measurement of the staging alone,
        tools/profile_train.py)."""
        self._stage(self._inputs(it0, texts, lab_texts, lab_ys), it0)

    def _inputs(self, it0, texts, lab_texts, lab_ys):
        beta, temp = zip(*(self.step.schedule(it0 + i)
                           for i in range(self.unroll)))
        return {"text": torch.as_tensor(texts),
                "lab_text": torch.as_tensor(lab_texts),
                "lab_y": torch.as_tensor(lab_ys),
                "beta": torch.tensor(beta, dtype=torch.float32),
                "temp": torch.tensor(temp, dtype=torch.float32)}

    def _draws(self, it0, inputs, dev, out=None):
        B, T = inputs["text"].shape[1:]
        B_lab = inputs["lab_text"].shape[1]
        return [draw_full_step(
            self.model, runtime.generator(dev, self.seed, _STEP_STREAM,
                                          it0 + i),
            B, B_lab, T, dev, self.cfgf, out=None if out is None else out[i])
            for i in range(self.unroll)]

    def _update(self, state, x, draws):
        return self.step.update(state["params"], state["opt"], x["text"],
                                x["lab_text"], x["lab_y"], x["beta"],
                                x["temp"], draws)


def check_phase2(model):
    """Raise a ValueError for the models whose phase 2 the JAX package
    cannot run either, before any step: a flow (its phase-2 ``vae_loss``
    calls ``model.forward(train=True)``, which raises for a flow,
    ``models/rnn_vae.py:272-276`` there) and the deconv family (its soft
    sampler, ``ops/sampling.py:69`` there, calls ``model.decode_step``,
    which has no deconv arm: a KeyError on its first step)."""
    if model.flow > 0:
        raise ValueError(
            "phase 2 with a flow is not a capability of the JAX package: "
            "its vae_loss calls model.forward(train=True), which raises "
            "'flow prior during training needs the flow-KL loss term' "
            "(models/rnn_vae.py:272-276 there); train a flow model with "
            "--phase 1")
    if model.G_class == "deconv":
        raise ValueError(
            "phase 2 with G_class deconv is not a capability of the JAX "
            "package: its soft sampler (ops/sampling.py:69, "
            "sample_sentences) steps model.decode_step, which has no deconv "
            "arm; train a deconv model with --phase 1")


def train_full(cfg, model, dataset, params, logger=None,
               lab_iterator="train_amp_lab"):
    """Run the phase-2 loop on the device the params live on, from
    ``params`` (a fresh classifier is added when they have none) or, when
    ``cfg.loadpath`` is set, from that file, loaded non-strictly (a
    phase-1 file has no classifier). Checkpoints ``{'params', 'step'}``
    at every ``expsvlog_every`` after ``s_iter``. Returns (params,
    steps_per_sec over the whole loop); the rate from step ``s_iter +
    WARM_STEPS`` on is logged as full_steps_per_sec_warm. A flow or the
    deconv family raises (``check_phase2``). Under tensor or pipeline
    parallelism the params returned are the full tree gathered from the
    ranks."""
    check_phase2(model)
    cfgf = cfg.full
    # a process group selects the parallel iteration: under hw.tp or
    # hw.pp the JAX package's make_tp_full_step / make_pp_model step over
    # a mesh, else its make_dp_full_step; ZeRO-1 is phase 1's alone, as
    # there
    mesh, shard = pdist.parallel_layout(
        cfg, [cfgf.batch_size, cfg.vae.batch_size])
    dev = next(iter(checkpoints.flatten(params).values())).device
    if "clf" not in params:
        params = dict(params, clf=model.init_classifier(
            runtime.generator(dev, cfg.seed, _CLF_STREAM), dev))
    if cfg.loadpath:
        params = checkpoints.load_params(cfg.loadpath, params, dev)
        log.info("Loaded params from %s", cfg.loadpath)
    mmd_cfg = cfg.losses.wae_mmd
    rf_basis = L.init_rf_basis(runtime.generator(dev, cfg.seed, _RF_STREAM),
                               model.z_dim, mmd_cfg.rf_dim, dev)
    writer = pdist.is_writer()
    if mesh is not None:
        model = mesh.wrap(model)
        params = mesh.shard(params)
        log.info("model-parallel phase-2 training over %r", mesh)
    elif shard is not None:
        log.info("data-parallel phase-2 training over %d ranks (%s)",
                 shard.world, shard.backend)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)
    step = FullStep(model, cfgf, cfg.losses, rf_basis, shard, mesh)
    opt_states = step.init(params)
    # runs of `unroll` iterations as one chunk, aligned to the log
    # cadences; under tensor parallelism every iteration is eager, as in
    # JAX (train/train_full.py:250-253 there)
    unroll = aligned_unroll(int(cfg.hw.get("unroll", 1) or 1),
                            int(cfgf.cheaplog_every),
                            int(cfgf.expsvlog_every))
    if mesh is not None and mesh.tp > 1:
        unroll = 1
    chunk = None
    if unroll > 1:
        check_chunk(mesh or shard, dev, unroll)
        chunk = FullChunk(model, cfgf, cfg.losses, rf_basis, unroll,
                          cfg.seed, shard, mesh)

    attr_name = dataset.attributes[0][0]

    def sink(p_it, vals):
        if logger is not None:
            for k, v in vals.items():
                logger.log_value("full_" + k, v, p_it)
        log.info("ITER %d (phase 2). L_vae: %.4f; attr_c: %.4f; "
                 "attr_z: %.4f; clf_sup: %.4f; clf_acc: %.3f",
                 p_it, vals["L_vae"], vals["L_attr_c"], vals["L_attr_z"],
                 vals["L_clf_sup"], vals["clf_acc"])

    fetch = DeferredFetch(cfg.hw.get("log_flush_every", 10), sink)

    def needs_host(j):
        return j % cfgf.cheaplog_every == 0 or j % cfgf.expsvlog_every == 0

    def do_host(it, metrics):
        cheap = it % cfgf.cheaplog_every == 0
        expsv = it % cfgf.expsvlog_every == 0
        save = expsv and it > cfgf.s_iter
        # on a mesh the full tree from every rank's parts, gathered by all
        full = mesh.gather(params) if save and mesh is not None else params
        if not writer:
            return
        if cheap or expsv:
            fetch.add(it, metrics, force=expsv)
        if save:
            path = cfgf.chkpt_path.format(it)
            checkpoints.save(path, full, step=it)
            log.info("Saved model to %s", path)

    def batch():
        text = dataset.next_batch("train_vae").text
        lab = dataset.next_batch(lab_iterator)
        return text, lab.text, np.maximum(getattr(lab, attr_name), 0)

    log.info("Training full (controlled-generation) phase ...")
    it, end_it = cfgf.s_iter, cfgf.s_iter + cfgf.n_iter
    T = cfg.max_seq_len
    warm_it, t_warm = None, None
    t_start = time.perf_counter()
    while it <= end_it:
        if warm_it is None and it >= cfgf.s_iter + WARM_STEPS:
            runtime.synchronize(dev)
            warm_it, t_warm = it, time.perf_counter()
        # a chunk whenever no iteration inside it needs the host except
        # possibly its last; the batches and draws are the same either way
        if chunk is not None and it + unroll - 1 <= end_it and not any(
                needs_host(it + j) for j in range(unroll - 1)):
            batches = [np.stack(b) for b in zip(*(batch()
                                                  for _ in range(unroll)))]
            metrics = chunk(params, opt_states, *batches, it)
            it += unroll
            do_host(it - 1, metrics)
            continue
        text, lab_text, lab_y = (torch.from_numpy(b).to(dev)
                                 for b in batch())
        draws = draw_full_step(
            model, runtime.generator(dev, cfg.seed, _STEP_STREAM, it),
            text.shape[0], lab_text.shape[0], T, dev, cfgf)
        metrics = step(params, opt_states, text, lab_text, lab_y, it, draws)
        do_host(it, metrics)
        it += 1
    fetch.flush()
    runtime.synchronize(dev)
    t_end = time.perf_counter()
    steps_per_sec = (cfgf.n_iter + 1) / max(t_end - t_start, 1e-9)
    if chunk is not None and chunk.node_kinds is not None:
        log.info(chunk.summary())
        log.info("CUDA graph %s", json.dumps(chunk.stats()))
    if logger is not None:
        logger.log_value("full_steps_per_sec", steps_per_sec, end_it)
        if warm_it is not None:
            logger.log_value("full_steps_per_sec_warm",
                             (end_it + 1 - warm_it)
                             / max(t_end - t_warm, 1e-9), end_it)
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(False)
    if mesh is not None:
        params = mesh.gather(params)
    return params, steps_per_sec
