"""CLaSS sampling pipeline.

Fit the attribute-conditioned marginal posterior Q_xi^a(z) (GMM by EM on
the device), fit latent logistic-regression attribute heads, then loop:
one fused round per launch (latent/fused.py: draw, heads, accept,
beam-decode on the device), dedup and physchem on the host, until enough
accepted samples exist. Up to hw.rounds_in_flight rounds are queued ahead
of the one being consumed; each round's results come back by an
asynchronous copy.

``hw.fused_rounds=0`` runs the serial loop instead, round by round as the
reference's sample_pipeline does: rejection sampling
(``latent/class_sampler.py``), then the beam decode of every candidate in
chunks of 1,024 (``decode_from_z``), dedup by peptide string and physchem
per peptide, in a pandas frame.

Each round draws from its own torch.Generator seeded from (cfg.seed,
round_ix), so the candidate stream does not depend on the schedule.

``hw.dp`` > 1 (0: every visible device) shards each round over the first
``hw.dp`` devices of this process (``parallel/rounds.py``, the JAX
package's ``dp_fused_round`` and ``dp_rejection_round``): the same draws,
n / D candidates a device, the same tokens and accept masks as one
device; ``run_from_states`` also takes the device list itself.
"""

import datetime
import inspect
import json
import logging
import os
import time
from collections import deque

import numpy as np
import torch

from . import config as C
from .api import (load_trained_model, get_model_and_vocab_path,
                  get_result_for_model, load_vocab)
from .data.loader import AttributeDataLoader
from .evals.peptide_evals import compute_modlamp, modlamp_from_tokens
from .latent import class_sampler, density, fused, logreg
from .ops import beam as beam_ops
from .parallel import rounds as dp_rounds
from .train import checkpoints
from .utils import runtime, tracing
from .vis import build_index

LOG = logging.getLogger("GenerationAPI")

Q_KWARGS = {"n_components": None, "z_num_samples": 10,
            "covariance_type": None}
Q_CLASSES = {"mogQ": density.mogQ, "fullQ": density.fullQ,
             "gaussianQ": density.gaussianQ}

# beam width of every pipeline decode
DECODE_BEAM_SIZE = 5
# latents per beam launch of the serial loop's decode
DECODE_CHUNK = 1024


def is_device_oom(e):
    """True only for the CUDA caching allocator's out-of-memory error: the
    callers that shrink their rounds on it must not do so on any other
    error whose message mentions memory."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def resolve_QClass(name):
    try:
        return Q_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown QClass {name!r}; one of {sorted(Q_CLASSES)}") from None


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def load_states(cfg, splits=("train", "test")):
    """{split: {mu, logvar, label, ...}} from the states dumps (the
    ``.h5`` where h5py imports, else the ``.npz``; a missing dump raises
    FileNotFoundError naming the port's ``static_eval --long``)."""
    return {split: build_index.read_states(build_index.states_path(
        cfg.savepath, split, cfg.vae.n_iter)) for split in splits}


def get_encodings_from_states(states, query, attributes):
    """Rows of one split's states matching {attr_name: label}."""
    attr_to_colix = {k: i for i, (k, _) in enumerate(attributes)}
    mu = np.asarray(states["mu"]).astype(np.float64)
    logvar = np.asarray(states["logvar"]).astype(np.float64)
    lab = np.asarray(states["label"])
    sel = np.ones(lab.shape[0], bool)
    for attr_name, val in query.items():
        sel &= lab[:, attr_to_colix[attr_name]] == val
    return mu[sel], logvar[sel]


@torch.no_grad()
def get_encodings_from_dataloader(cfg, query, split, model, params,
                                  dataloader):
    """(mu, logvar) as float32 numpy arrays of the amp-positive rows of
    ``split`` (e.g. "train,val"), encoded straight from the dataloader in
    batches of cfg.vae.batch_size, one pass in its shuffled order. The JAX
    package encodes through ``forward(q_c="classifier", sample_z="max",
    train=False)``; mu and logvar do not depend on c, so this calls
    ``model.encode(train=False)``, the same numbers. Without autograd the GRU encoder's scans run the forward-only
    kernel B4 on the card."""
    if query != {"amp": 1}:
        raise ValueError(f"the dataloader encodings select amp=1 only, as "
                         f"in the JAX package (got {query}); pass "
                         f"--Q_select_amppos 1")
    spec = {"get_encoding": {
        "subset": [f"split={split}", "amp=amp_posc,amp_posnc"],
        "repeat": False}}
    iterators, _ = dataloader.get_subset_iterators(spec, cfg.vae.batch_size)
    dev = next(iter(checkpoints.flatten(params).values())).device
    mus, logvars = [], []
    for rows in iterators["get_encoding"]:
        text = torch.from_numpy(dataloader._make_batch(rows).text).to(dev)
        mu, logvar = model.encode(params, text, train=False)
        mus.append(mu.cpu().numpy())
        logvars.append(logvar.cpu().numpy())
    return np.concatenate(mus), np.concatenate(logvars)


def load_dataloader(cfg):
    """The run's dataset, batched at cfg.vae.batch_size (the JAX
    package's ``run`` loads it the same way)."""
    spec = C.dataset_spec(cfg)
    spec.pop("synthetic", None)
    return AttributeDataLoader(mbsize=cfg.vae.batch_size,
                               max_seq_len=cfg.max_seq_len, **spec)


# ---------------------------------------------------------------------------
# Q fit + latent classifiers
# ---------------------------------------------------------------------------

def fitQ_and_test(cfg, QClass, QKwargs, states, Q_select=None, device="cpu",
                  model=None, params=None, dataloader=None):
    """Fit Q on the train split's selection, or, given a model and a
    dataloader, on the encodings of the dataloader's train and val rows
    (--Q_from_full_dataloader); NLL on the states' train and test."""
    Q_select = Q_select or {}
    attributes = C.dataset_spec(cfg)["attributes"]
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    if model is not None and dataloader is not None:
        mu, logvar = get_encodings_from_dataloader(
            cfg, Q_select, "train,val", model, params, dataloader)
    else:
        mu, logvar = get_encodings_from_states(states["train"], Q_select,
                                               attributes)
    # keep only the kwargs this Q family's __init__ accepts
    accepts = set(inspect.signature(QClass.__init__).parameters)
    qkw = {k: v for k, v in QKwargs.items()
           if v is not None and k in accepts}
    if "gen" in accepts:
        qkw["gen"] = gen
    Q = QClass(np.asarray(mu, np.float32), np.asarray(logvar, np.float32),
               device=device, **qkw)
    if hasattr(Q, "info"):
        LOG.info("mog-%s. Converged: %s in %s iters, "
                 "log likelihood lower bound: %.4f",
                 qkw.get("n_components"), Q.info.converged, Q.info.n_iter,
                 Q.info.lower_bound)
    LOG.info("Fitted %s %s on selection %s", QClass.__name__,
             str({k: v for k, v in qkw.items() if k != "gen"}),
             str(Q_select))
    metrics = {}
    for name, split in (("a,tr", "train"), ("a,hld", "test")):
        points = get_encodings_from_states(states[split], Q_select,
                                           attributes)
        metrics[name] = density.evaluate_nll(Q, points, gen=gen)
    return Q, metrics


def build_clfZ(cfg, attr, states, attributes=None, device="cpu"):
    """Latent logistic-regression head attr=1 vs attr=0 on encoder means."""
    attributes = attributes or C.dataset_spec(cfg)["attributes"]
    zpos_mu, _ = get_encodings_from_states(states["train"], {attr: 1},
                                           attributes)
    zneg_mu, _ = get_encodings_from_states(states["train"], {attr: 0},
                                           attributes)
    X = torch.as_tensor(np.concatenate([zpos_mu, zneg_mu]),
                        dtype=torch.float32, device=device)
    y = torch.cat([torch.ones(len(zpos_mu), device=device),
                   torch.zeros(len(zneg_mu), device=device)])
    clf, _ = logreg.fit(X, y)
    acc = float(logreg.accuracy(clf, X, y))
    LOG.info("Fitted LogReg classifier in z-space, on attr=%s.", attr)
    LOG.info("num samples: %d pos, %d neg. train accuracy=%.5f",
             len(zpos_mu), len(zneg_mu), acc)
    return clf


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def decode_top1(z, model, shards, gen=None, chunk=DECODE_CHUNK,
                beam_size=DECODE_BEAM_SIZE, cs=None, plain=False):
    """Beam-decode latents in chunks of ``chunk``, the last zero-padded to
    the full width; c per chunk drawn from ``gen`` (``cs``: the chunks'
    c, each [chunk, c_dim], injected). Returns the top-1 hypotheses
    (tokens [n, T+1] int64, scores [n] f32) as numpy arrays. On CUDA
    tensors every chunk launches the family's beam kernel (B1 or B3) where
    its scope covers the model, as ``generation.generate_sentences``
    routes; ``plain=True`` runs the plain version (for comparisons).

    A posterior flow maps the latents before the chunking (the JAX
    package's ``decode_from_z``: Q lives in the encoder's z0 space), a
    gen_prior flow each padded chunk (its ``generate_sentences``). The
    deconv family decodes a chunk's logits at once, pad rows included (its
    batch norm reads them, as in the JAX package), and replays them in
    ``beam_search_logits``. ``shards`` (``parallel.rounds.Shards``, one
    entry for one device) holds the params: chunk j decodes on device j
    mod D, its c drawn on the first device whatever D is."""
    dev = shards.devices[0]
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    if model.flow > 0 and model.flow_mode == "posterior":
        z = model.apply_flow(shards.replicas[0], z)[0]
    n = z.shape[0]
    toks, scores = [], []
    for j, s in enumerate(range(0, n, chunk)):
        zc = z[s:s + chunk]
        pad = chunk - zc.shape[0]
        if pad:
            zc = torch.cat([zc, zc.new_zeros((pad, z.shape[1]))])
        c = (model.sample_c_prior(gen, chunk, device=dev) if cs is None
             else torch.as_tensor(cs[j], dtype=torch.float32, device=dev))
        i = j % len(shards.devices)
        params = shards.replicas[i]
        zc, c = zc.to(shards.devices[i]), c.to(shards.devices[i])
        if model.flow > 0 and model.flow_mode == "gen_prior":
            zc = model.apply_flow(params, zc)[0]
        if model.G_class == "deconv":
            hyps, sc = beam_ops.beam_search_logits(
                model.decode_logits(params, zc, c), beam_size=beam_size,
                n_best=1)
        else:
            route_plain = plain or not beam_ops.in_kernel_scope(
                model, params, zc, beam_size)
            hyps, sc = beam_ops.beam_search(model, params, zc, c,
                                            beam_size=beam_size, n_best=1,
                                            plain=route_plain)
        toks.append(hyps[:chunk - pad, 0].cpu().numpy())
        scores.append(sc[:chunk - pad, 0].cpu().numpy())
    return np.concatenate(toks), np.concatenate(scores)


def decode_from_z(z, model, shards, vocab, gen=None, chunk=DECODE_CHUNK,
                  beam_size=DECODE_BEAM_SIZE, cs=None):
    """``decode_top1``'s tokens as peptide strings (specials stripped)."""
    LOG.info("Decoder decoding: beam search")
    tokens, _ = decode_top1(z, model, shards, gen, chunk, beam_size, cs)
    return vocab.to_sentences_batch(tokens, print_special_tokens=False)


def get_new_samples(model, shards, vocab, Q, n_samples, gen):
    """One serial round: rejection-sample n latents, decode all of them,
    and return the per-sample frame (peptide, z as float16 rows, accept_z,
    the score columns). ``gen`` draws the rejection round, then each
    decode chunk's c. The rejection round and the decode chunks run over
    the devices of ``shards``."""
    import pandas as pd
    z, scores, accept = class_sampler.sample_round(
        shards.devices, class_sampler.rejection_draws(
            gen, Q._sampler()[1], n_samples), Q)
    peptides = decode_from_z(z, model, shards, vocab, gen=gen)
    return pd.DataFrame({
        "peptide": peptides,
        "z": list(z.to(torch.float16).cpu().numpy()),
        "accept_z": accept.cpu().numpy(),
        **{k: v.cpu().numpy() for k, v in scores.items()},
    })


def one_sampling_round(model, shards, vocab, Q, n_samples_per_round, gen):
    df = get_new_samples(model, shards, vocab, Q, n_samples_per_round, gen)
    df = compute_modlamp(df)
    df["accept"] = df["accept_z"]
    return df


def round_capacity(cfg, n_samples, n_dev=1):
    """Decode-slot capacity for hw.decode_mode="accepted", or None for the
    decode-all reference contract; over ``n_dev`` devices rounded up to a
    multiple of them (n_samples is one too), as the JAX package's."""
    if cfg.hw.get("decode_mode", "all") != "accepted":
        return None
    frac = float(cfg.hw.get("accept_cap_frac", 0.5))
    capacity = max(int(round(n_samples * frac)), 1)
    capacity += (-capacity) % max(int(n_dev), 1)
    return min(capacity, n_samples)


def transformer_dispatch_budget(cfg, model, n_dp=1):
    """Max candidates per launch for the transformer decoder family, or
    None (other families): hw.tfm_lane_budget_gb (a device's) times the
    ``n_dp`` devices a round is sharded over, over 6x the raw KV-cache
    bytes per candidate, the JAX package's rule (its factor is its
    measured program overhead on the TPU; the port keeps it so that one
    setting means the same on both). run_from_states clamps
    rounds_per_dispatch to it."""
    per_cand = transformer_cache_bytes_per_candidate(cfg, model)
    if per_cand is None:
        return None
    budget = int(float(cfg.hw.get("tfm_lane_budget_gb", 4.0)) * 2**30) * max(
        int(n_dp), 1)
    return max(int(budget / max(6 * per_cand, 1)), 1)


def transformer_cache_bytes_per_candidate(cfg, model):
    """Raw KV-cache bytes one candidate's beam lanes carry through a round
    (L * (T+1) * d_model * k/v * the decode type's bytes * beam, times the
    slot fraction under decode_mode "accepted"), or None for other
    families."""
    if model.G_class != "transformer":
        return None
    t_args = model.dec_tfm_args
    dt = getattr(torch, cfg.hw.get("gen_dtype", "float32"))
    cache_bytes = (t_args.get("n_layers", 2) * (model.max_seq_len + 1)
                   * t_args.get("d_model", 128) * 2
                   * torch.empty((), dtype=dt).element_size())
    cap = float(cfg.hw.get("accept_cap_frac", 0.5))
    return cache_bytes * DECODE_BEAM_SIZE * (
        cap if cfg.hw.get("decode_mode", "all") == "accepted" else 1.0)


def round_generator(seed, round_ix, device):
    """The generator of round ``round_ix``, seeded from (seed, round_ix)."""
    return runtime.generator(device, seed, round_ix)


def launch_round(cfg, model, shards, Q, n_samples, gen):
    """Enqueue one round's device work and an asynchronous copy of its
    results to the host.

    Returns (host, span): host = (z, scores, accept, tokens, valid) as CPU
    tensors, readable once ``span`` (a ``tracing.DeviceSpan`` from before
    the round's first device operation to after its host copies; None on
    the CPU) has completed: ``span.synchronize()`` waits for it.
    Under hw.decode_mode="all" valid is None; under "accepted" z, scores
    and tokens hold the compacted slots and valid marks real ones. The
    round runs over the devices of ``shards`` (``parallel.rounds.Shards``,
    one entry for one device)."""
    capacity = round_capacity(cfg, n_samples, len(shards.devices))
    q_params = Q._sampler()[1]
    # the draws' device, on which the round's rows are joined
    span = tracing.device_span(q_params.means.device)
    draws = fused.round_draws(gen, q_params, n_samples)
    kwargs = dict(beam_size=DECODE_BEAM_SIZE,
                  decode_dtype=cfg.hw.get("gen_dtype", "float32"),
                  capacity=capacity)
    out = fused.fused_round(model, shards, draws, Q, **kwargs)
    z, scores, accept, tokens = out[:4]
    valid = out[5] if capacity is not None else None
    # z is kept only as a float16 artifact column, token ids fit a byte
    z = z.to(torch.float16)
    if model.n_vocab < 256:
        tokens = tokens.to(torch.uint8)
    cpu = lambda t: None if t is None else t.to("cpu", non_blocking=True)
    host = (cpu(z), {k: cpu(v) for k, v in scores.items()}, cpu(accept),
            cpu(tokens), cpu(valid))
    return host, None if span is None else span.end()


def canonical_keys(tokens):
    """Dedup keys for decoded token rows: each row's residue tokens
    (> EOS_IDX) left-packed over a zero tail, exactly the content the
    decoded string shows. Returns an iterator of bytes."""
    residue = tokens > 3  # specials pinned at 0..3 (vocab contract)
    order = np.argsort(~residue, axis=1, kind="stable")
    keys = np.take_along_axis(np.where(residue, tokens, 0), order, axis=1)
    return map(bytes, keys)


class BeamCanaryError(RuntimeError):
    """A round's unique-sequence ratio collapsed in the CUDA beam kernel."""


def beam_canary_check(cfg, device, n_rows, n_unique, context="",
                      model=None, params=None):
    """CUDA beam kernel canary: a tape-corruption fault collapses
    within-round uniqueness. Below hw.beam_canary_floor on a CUDA device
    it raises (the JAX package flips to its XLA arm instead; here a quiet
    switch would hide the kernel). On the CPU the plain version decodes
    and low uniqueness is the model's own, as it is where ``model`` (with
    its ``params``) decodes outside the beam kernels (skip connections, the
    deconv family: the JAX package's canary checks only a live kernel
    route). Returns False when the check passes or does not apply."""
    floor = float(cfg.hw.get("beam_canary_floor", 0.02))
    min_rows = int(cfg.hw.get("beam_canary_min_rows", 256))
    if floor <= 0 or n_rows < min_rows or torch.device(device).type != "cuda":
        return False
    if model is not None and not beam_ops.in_kernel_scope(
            model, params, torch.empty(0, dtype=getattr(
                torch, cfg.hw.get("gen_dtype", "float32"))),
            DECODE_BEAM_SIZE):
        return False
    if n_unique / max(n_rows, 1) >= floor:
        return False
    raise BeamCanaryError(
        f"beam canary tripped{f' ({context})' if context else ''}: "
        f"{n_unique}/{n_rows} unique decoded sequences "
        f"(< hw.beam_canary_floor={floor:.3f}) from the CUDA beam kernel; "
        f"hold the kernel against its plain version with chip_smoke.py, or "
        f"rerun with --device cpu")


def _log_round_rates(n_accept_z, n_accept, n_total, dropped):
    if dropped > 0:
        LOG.info("Dropped %d duplicate samples", dropped)
    LOG.info("Q_xi(z|a) rejection sampling acceptance rate: "
             "%d/%d = %.4f", n_accept_z, n_total,
             100.0 * n_accept_z / max(n_total, 1))
    LOG.info("     - full filter pipeline accepted: %d/%d = %.4f",
             n_accept, n_total, 100.0 * n_accept / max(n_total, 1))


def _fused_sampling_loop(cfg, args, model, shards, vocab, Q, round_size,
                         device):
    """Rounds until n_samples_acc unique accepted samples exist.

    Returns (samples, stats): samples is a dict of columns, in file order
    (peptide, z, accept_z, scores..., H, uH, charge, accept)."""
    depth = max(int(cfg.hw.get("rounds_in_flight", 2)), 1)
    seen = set()
    store = {"peptide": [], "z": [], "accept_z": [], "H": [], "uH": [],
             "charge": []}
    score_store = {}
    n_total = n_accept = n_cand_seen = n_accept_z_seen = 0
    round_ix = 0
    inflight = deque()

    def launch_one():
        nonlocal round_ix, round_size
        round_ix += 1
        LOG.info("Round #%d (x%d candidates per launch)", round_ix,
                 round_size)
        # a round too large for the card's memory halves and retries (the
        # next rounds keep the smaller size), down to one candidate; any
        # other error propagates
        while True:
            try:
                out = launch_round(cfg, model, shards, Q, round_size,
                                   round_generator(cfg.seed, round_ix,
                                                   device))
                break
            except Exception as e:
                shrink = round_size // 2
                shrink -= shrink % len(shards.devices)
                if not is_device_oom(e) or shrink < 1:
                    raise
                LOG.warning("round out of device memory at %d candidates; "
                            "retrying at %d (tune hw.tfm_lane_budget_gb)",
                            round_size, shrink)
                round_size = shrink
        inflight.append(out)

    rounds_consumed = 0
    while True:
        while len(inflight) < depth:
            launch_one()
        (z, scores, accept_full, tokens, valid), span = inflight.popleft()
        if span is not None:
            span.synchronize()
        rounds_consumed += 1
        z, tokens = z.numpy(), tokens.numpy()
        accept_full = accept_full.numpy()
        scores = {k: v.numpy() for k, v in scores.items()}
        n_candidates = accept_full.shape[0]
        if valid is not None:
            # accepted-only decode: keep the valid compacted slots; every
            # kept row is accepted by construction
            v = valid.numpy()
            over_cap = int(accept_full.sum()) - int(v.sum())
            if over_cap > 0:
                LOG.info("Accepted candidates beyond decode capacity "
                         "dropped: %d", over_cap)
            z, tokens = z[v], tokens[v]
            scores = {k: s[v] for k, s in scores.items()}
            accept_z = np.ones(tokens.shape[0], bool)
        else:
            accept_z = accept_full

        keys = list(canonical_keys(tokens))
        beam_canary_check(cfg, device, len(keys), len(set(keys)),
                          context=f"campaign round {rounds_consumed}",
                          model=model, params=shards.replicas[0])
        keep = np.empty(tokens.shape[0], bool)
        for i, rb in enumerate(keys):
            keep[i] = rb not in seen
            seen.add(rb)
        kept_tokens = tokens[keep].astype(np.int64)
        store["peptide"].extend(vocab.to_sentences_batch(
            kept_tokens, print_special_tokens=False))
        H, uH, charge = modlamp_from_tokens(kept_tokens, vocab.itos)
        store["z"].append(z[keep])
        store["accept_z"].append(accept_z[keep])
        store["H"].append(H)
        store["uH"].append(uH)
        store["charge"].append(charge)
        for k, s in scores.items():
            score_store.setdefault(k, []).append(s[keep])
        n_total += int(keep.sum())
        n_accept += int(accept_z[keep].sum())
        n_cand_seen += n_candidates
        n_accept_z_seen += int(accept_full.sum())
        _log_round_rates(n_accept_z_seen, n_accept, n_cand_seen,
                         keep.size - int(keep.sum()))
        if n_total >= args.n_samples_acc and n_accept >= args.n_samples_acc:
            break
    # rounds still in flight are dropped unread (their draws are i.i.d.)

    samples = {
        "peptide": store["peptide"],
        **{k: np.concatenate(store[k]) for k in ("z", "accept_z")},
        **{k: np.concatenate(v) for k, v in score_store.items()},
        **{k: np.concatenate(store[k]) for k in ("H", "uH", "charge")},
    }
    samples["accept"] = samples["accept_z"].copy()
    stats = {"rounds": rounds_consumed, "rounds_launched": round_ix,
             "candidates": n_cand_seen, "accepted_z": n_accept_z_seen,
             "unique": n_total, "unique_accepted": n_accept}
    return samples, stats


def _serial_sampling_loop(cfg, args, model, shards, vocab, Q, round_size,
                          device):
    """The reference-shaped strict round-by-round loop
    (``hw.fused_rounds=0``): each round's frame deduplicated by peptide
    string, within the round and against every earlier round, until
    n_samples_acc unique peptides, n_samples_acc of them accepted, exist.
    The logged rates divide by the unique samples kept, as the
    reference's do. Returns (frame, stats)."""
    import pandas as pd
    samples = pd.DataFrame(columns=["peptide"])

    def is_finished(df, min_accepted):
        return not (len(df) < min_accepted
                    or df["accept"].sum() < min_accepted)

    round_ix = n_accept_z_seen = 0
    while not is_finished(samples, args.n_samples_acc):
        round_ix += 1
        LOG.info("Round #%d (x%d candidates per dispatch)", round_ix,
                 round_size)
        new = one_sampling_round(model, shards, vocab, Q, round_size,
                                 round_generator(cfg.seed, round_ix,
                                                 device))
        n_accept_z_seen += int(new["accept_z"].sum())
        beam_canary_check(cfg, device, len(new), new["peptide"].nunique(),
                          context=f"serial round {round_ix}", model=model,
                          params=shards.replicas[0])
        new = new.loc[new.peptide.drop_duplicates().index]
        new = new[~new["peptide"].isin(samples["peptide"])]
        samples = pd.concat([samples, new], ignore_index=True, sort=False)
        _log_round_rates(int(samples["accept_z"].sum()),
                         int(samples["accept"].sum()), len(samples),
                         round_size - new.shape[0])
    stats = {"rounds": round_ix, "rounds_launched": round_ix,
             "candidates": round_ix * round_size,
             "accepted_z": n_accept_z_seen, "unique": len(samples),
             "unique_accepted": int(samples["accept"].sum())}
    return samples, stats


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

def _samples_frame(samples):
    """The samples as the JAX package's sampling loop hands them to its
    save_samples: a pandas DataFrame of the same columns in the same order,
    z as a column of row arrays (pandas is imported only here)."""
    import pandas as pd
    return pd.DataFrame({k: list(v) if k in ("peptide", "z") else v
                         for k, v in samples.items()})


def _frame_columns(frame):
    """The serial loop's frame as the fused loop's dict of columns, in the
    same order: z stacked [n, D] float16, the masks bool (concatenating
    onto the loop's empty first frame makes them object columns)."""
    out = {k: frame[k].to_numpy() for k in frame.columns}
    out["peptide"] = frame["peptide"].tolist()
    out["z"] = np.stack(out["z"]).astype(np.float16)
    for k in ("accept_z", "accept"):
        out[k] = out[k].astype(bool)
    return out


def _save_csv_pkl(samples, fn):
    """``fn``.csv (no z column, an ``idx`` label) and ``fn``.pkl, written
    as the JAX package writes them (``pipeline.py:save_csv_pkl`` there)."""
    samples.drop(columns="z").to_csv(fn + ".csv", index_label="idx")
    samples.to_pickle(fn + ".pkl")


def save_samples(samples, basedir, fn_prefix):
    """<prefix>_<date>.plain.txt / .csv / .pkl, and the accepted subset as
    <prefix>_<date>.accepted.<n>.csv / .pkl, byte for byte as the JAX
    package's ``save_samples`` writes the same samples. Returns the path
    stem."""
    samples = _samples_frame(samples)
    outfn = os.path.join(basedir, fn_prefix)
    outfn += "_{}".format(datetime.datetime.now().isoformat().split("T")[0])
    with open(outfn + ".plain.txt", "w") as fh:
        fh.write(samples["peptide"].to_string(index=False))
    _save_csv_pkl(samples, outfn)
    LOG.info("Full sample list written to %s.pkl/csv", outfn)
    accepted = samples[samples.accept]
    accepted_fn = f"{outfn}.accepted.{len(accepted)}"
    _save_csv_pkl(accepted, accepted_fn)
    LOG.info("Accepted sample list written to %s.pkl/csv", accepted_fn)
    return outfn


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def make_shards(cfg, params, device, devices=None):
    """The ``parallel.rounds.Shards`` a round runs over: ``devices`` when
    given (a list naming one device twice is two shards on it), else
    ``hw.dp``'s (``rounds.devices_for``, which raises for more devices
    than are visible)."""
    if devices is None:
        devices = dp_rounds.devices_for(cfg, device)
    if len(devices) > 1:
        LOG.info("CLaSS rounds sharded over %d devices (%s)", len(devices),
                 ", ".join(map(str, devices)))
    return dp_rounds.shards_of(params, devices)


def run(cfg, args, device="cuda"):
    """Full pipeline main: read the run dir, then run_from_states. Runs
    on CUDA unless ``device`` is the CPU; without CUDA it raises."""
    device = runtime.setup(device)
    model_path, vocab_path, _ = get_model_and_vocab_path(cfg)
    LOG.info("Load model, vocab, dataloader.")
    vocab = load_vocab(vocab_path)
    model, params = load_trained_model(model_path, vocab.size(), cfg,
                                       device=device)
    # only --Q_from_full_dataloader reads the corpus
    dataset = load_dataloader(cfg) if args.Q_from_full_dataloader else None
    LOG.info("Loaded model succesfully.")
    try:
        metrics = get_result_for_model(model_path)
        LOG.info("Model metrics: %s", json.dumps(metrics)[:500])
    except FileNotFoundError:
        LOG.info("No result.json next to model; continuing.")
    states = load_states(cfg)
    return run_from_states(cfg, args, model, params, vocab, states,
                           device, dataset)[0]


def run_from_states(cfg, args, model, params, vocab, states, device="cuda",
                    dataset=None, devices=None):
    """Everything run does after its file reads: fit Q and the heads on
    ``states`` ({'train': ..., 'test': ...} with mu, logvar, label),
    sample, write the sample files. Returns (path stem, samples, stats).
    ``model``/``params`` must already be on ``device``. With
    ``--Q_from_full_dataloader`` Q is fitted on the encodings of
    ``dataset`` (``load_dataloader(cfg)``, which the caller passes); the
    eval points and the heads still come from ``states``, as in the JAX
    package. ``devices`` (default: ``hw.dp``'s) shards every round over
    a device list (``make_shards``)."""
    device = runtime.setup(device)
    shards = make_shards(cfg, params, device, devices)
    if args.Q_from_full_dataloader and dataset is None:
        raise ValueError("--Q_from_full_dataloader needs the dataset: pass "
                         "dataset=load_dataloader(cfg)")
    attributes = C.dataset_spec(cfg)["attributes"]
    LOG.info("Fit attribute-conditioned marginal posterior Q_xi^a(z)")
    qkwargs = dict(Q_KWARGS)
    for k in qkwargs:
        if hasattr(args, "Q_" + k):
            qkwargs[k] = getattr(args, "Q_" + k)
    QClass = resolve_QClass(getattr(args, "QClass", "mogQ"))
    q_select = {"amp": 1} if args.Q_select_amppos else {}
    full = args.Q_from_full_dataloader
    Q, q_metrics = fitQ_and_test(
        cfg, QClass, qkwargs, states, q_select, device=device,
        model=model if full else None, params=params if full else None,
        dataloader=dataset if full else None)
    LOG.info("Q Fit metrics: %s", json.dumps(q_metrics, indent=4))
    z_clfs = {attr: build_clfZ(cfg, attr, states, attributes, device)
              for attr in ["amp", "tox"]}
    Q.init_attr_classifiers(z_clfs, clf_targets={"amp": 1, "tox": 0})

    rpd = max(int(cfg.hw.get("rounds_per_dispatch", 1)), 1)
    n_dev = len(shards.devices)
    budget = transformer_dispatch_budget(cfg, model, n_dev)
    if budget is not None:
        max_rpd = max(budget // args.n_samples_per_round, 1)
        if rpd > max_rpd:
            LOG.info("transformer decoder: clamping rounds_per_dispatch "
                     "%d -> %d (KV-cache lane budget %.1f GB x %d devices)",
                     rpd, max_rpd,
                     float(cfg.hw.get("tfm_lane_budget_gb", 4.0)), n_dev)
            rpd = max_rpd
    round_size = args.n_samples_per_round * rpd
    t_sampling = time.perf_counter()
    if cfg.hw.get("fused_rounds", True):
        samples, stats = _fused_sampling_loop(cfg, args, model, shards,
                                              vocab, Q, round_size, device)
    else:
        frame, stats = _serial_sampling_loop(cfg, args, model, shards, vocab,
                                             Q, round_size, device)
        samples = _frame_columns(frame)
    dt = time.perf_counter() - t_sampling
    n_acc = int(np.sum(samples["accept"]))
    stats["seconds"] = dt
    LOG.info("CLaSS throughput: %.1f accepted samples/sec "
             "(%d accepted, %d candidates, %.2fs)", n_acc / max(dt, 1e-9),
             n_acc, len(samples["peptide"]), dt)
    outfn = save_samples(samples, cfg.savepath, args.samples_outfn_prefix)
    return outfn, samples, stats
