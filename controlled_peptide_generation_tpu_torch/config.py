"""Config tree: single source of truth, dotted CLI flags, JSON round-trip.

Keeps the reference's config contract (reference: cfg.py:56-372):

* one nested tree of plain scalars is the single source of truth;
* every leaf is auto-exposed as a ``--dotted.path`` argparse flag;
* overrides can come from the CLI or a saved JSON file and are re-saved per
  run as ``config_overrides.json`` + ``config_complete.json``;
* ``--tiny 1`` collapses everything into a seconds-long smoke run;
* ``finalize()`` derives paths / schedules / auto-load checkpoints
  (reference: cfg.py:75-137 ``_update_cfg``).

The port's own copy of the JAX package's ``config.py``: the same default
tree, flags and dataset specs, with a finalize of its own (the JAX one
imports jax to set its kernel switches). The tree is an explicit object so
tests can build isolated configs.
"""

from __future__ import annotations

import copy
import json
import os

_SCALARS = (float, str, int, bool)


class Bunch(dict):
    """dict with attribute access; the nodes of the config tree."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def copy(self):
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# tree traversal: leaves are scalars, inner nodes are Bunch
# ---------------------------------------------------------------------------

def walk_leaves(tree, prefix=""):
    """Yield ``(dotted_key, value)`` for every scalar leaf, sorted by key."""
    for k in sorted(tree.keys()):
        if k.startswith("_"):
            continue
        v = tree[k]
        if isinstance(v, Bunch):
            yield from walk_leaves(v, prefix + k + ".")
        elif isinstance(v, _SCALARS):
            yield prefix + k, v


def set_dotted(tree, dotted, value):
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    if parts[-1] not in node:
        raise KeyError(f"unknown config key: {dotted}")
    old = node[parts[-1]]
    if isinstance(old, bool):
        value = bool(int(value)) if not isinstance(value, bool) else value
    elif isinstance(old, int) and not isinstance(value, bool):
        value = int(value)
    elif isinstance(old, float):
        value = float(value)
    node[parts[-1]] = value


def fill_parser(parser, tree):
    """Register one ``--dotted.key`` flag per scalar leaf (cfg.py:56-72)."""
    for key, val in walk_leaves(tree):
        parser.add_argument(
            f"--{key}", type=_flag_type(val), default=None,
            help=f"default: {val!r}")


def _flag_type(val):
    if isinstance(val, bool):
        # accept 0/1 like the reference's int-ish bools
        return lambda s: bool(int(s))
    return type(val)


def override_from_args(tree, args):
    """Apply non-None parsed argparse values onto the tree. Returns the dict
    of overrides that were applied (for config_overrides.json)."""
    applied = {}
    known = {k for k, _ in walk_leaves(tree)}
    for key, val in vars(args).items():
        if val is None or key not in known:
            continue
        set_dotted(tree, key, val)
        applied[key] = val
    return applied


def override_from_json(tree, config_json):
    """Apply a saved flat {dotted_key: value} JSON file (cfg.py:23-27)."""
    if not config_json:
        return {}
    with open(config_json) as fh:
        overrides = json.load(fh)
    known = {k for k, _ in walk_leaves(tree)}
    applied = {}
    for key, val in overrides.items():
        if key in known:
            set_dotted(tree, key, val)
            applied[key] = val
    return applied


def to_flat_dict(tree):
    return dict(walk_leaves(tree))


def save_config(overrides, tree, savepath):
    """Write config_overrides.json + config_complete.json (cfg.py:30-39)."""
    os.makedirs(savepath, exist_ok=True)
    with open(os.path.join(savepath, "config_overrides.json"), "w") as fh:
        json.dump(overrides, fh, indent=2, sort_keys=True)
    with open(os.path.join(savepath, "config_complete.json"), "w") as fh:
        json.dump(to_flat_dict(tree), fh, indent=2, sort_keys=True)


def pretty_print(tree, prefix="", out=print):
    for k in sorted(tree.keys()):
        if k.startswith("_"):
            continue
        v = tree[k]
        if isinstance(v, Bunch):
            out(f"{prefix}{k}:")
            pretty_print(v, prefix + "  |- ", out)
        elif isinstance(v, _SCALARS):
            out(f"{prefix}{k}\t{v}")


# ---------------------------------------------------------------------------
# default tree (reference: cfg.py:150-372)
# ---------------------------------------------------------------------------

def default_config():
    cfg = Bunch()
    # general
    cfg.config_json = ""
    cfg.seed = 1238
    cfg.tiny = False

    # paths
    cfg.tb_toplevel = "tb"
    cfg.savepath_toplevel = "output"
    cfg.runname = "default"
    cfg.datapath = "data"
    cfg.loadpath = "auto"
    cfg.vocab_path = "auto"
    cfg.phase = -1          # -1: both, 1: vae, 2: full
    cfg.part = 0
    cfg.partN = 1
    cfg.resume_result_json = True

    # phase-1 autoencoder training (cfg.py:171-188)
    cfg.vae = Bunch(
        batch_size=32,
        lr=1e-3,
        s_iter=0,
        n_iter=200000,
        beta=Bunch(
            start=Bunch(val=1.0, iter=0),
            end=Bunch(val=2.0, iter=10000),
        ),
        lambda_logvar_L1=0.0,
        lambda_logvar_KL=1e-3,
        z_regu_loss="mmdrf",      # kl (vae) | mmd (wae) | mmdrf (wae)
        cheaplog_every=500,
        expsvlog_every=20000,
    )
    cfg.vae.beta.start.iter = cfg.vae.s_iter
    cfg.vae.beta.end.iter = cfg.vae.s_iter + cfg.vae.n_iter // 5

    # phase-2 controlled-generation training config surface (cfg.py:191-231).
    # The reference never released the phase-2 trainer; the config block is
    # kept for CLI/JSON compatibility and for the soft-sampling machinery.
    cfg.full = Bunch(
        batch_size=32,
        lrE=3e-4,
        lrG=3e-4,
        lrC=3e-4,
        n_iter=50000,
        s_iter=cfg.vae.n_iter,
        classifier_min_length=5,
        beta=Bunch(
            start=Bunch(val=2.0, iter=cfg.vae.n_iter),
            end=Bunch(val=2.0, iter=cfg.vae.n_iter + 50000),
        ),
        z_regu_loss="mmdrf",
        C_hard_sample_kwargs=Bunch(sample_mode="categorical"),
        G_soft_sample_kwargs=Bunch(sample_mode="none_softmax"),
        softmax_temp=Bunch(
            start=Bunch(iter=cfg.vae.n_iter, val=1.0),
            end=Bunch(iter=cfg.vae.n_iter + 20000, val=1.0),
        ),
        lambda_e=0.1,
        lambda_c=1.0,
        lambda_z=0.1,
        lambda_u=0.1,
        lambda_logvar_L1=0.0,
        lambda_logvar_KL=1e-3,
        cheaplog_every=50,
        expsvlog_every=2000,
    )
    cfg.full.beta.start.iter = cfg.full.s_iter
    cfg.full.beta.end.iter = cfg.full.s_iter + cfg.full.n_iter
    cfg.full.softmax_temp.start.iter = cfg.full.s_iter
    cfg.full.softmax_temp.end.iter = cfg.full.s_iter + cfg.full.n_iter

    # shared, injected into vae/full in finalize() (cfg.py:234-236)
    cfg.shared = Bunch(clip_grad=5.0)

    # evals (cfg.py:239-245)
    cfg.evals = Bunch(
        sample_size=2000,
        sample_modes=Bunch(
            beam=Bunch(sample_mode="beam", beam_size=5, n_best=3),
        ),
    )

    # loss parametrization (cfg.py:248-256)
    cfg.losses = Bunch(
        wae_mmd=Bunch(
            sigma=7.0,
            kernel="gaussian",
            rf_dim=500,
            rf_resample=False,
        ),
    )

    cfg.max_seq_len = 25

    # model architecture (cfg.py:261-301)
    cfg.model = Bunch(
        z_dim=100,
        c_dim=2,
        emb_dim=150,
        freeze_embeddings=False,
        flow=0,
        flow_type="",
        # gen_prior = reference semantics (flow applied to prior samples at
        # generation, untrainable — forward raises during training);
        # posterior = trainable flow-posterior objective (losses.kl_flow_mc)
        flow_mode="gen_prior",
        E_args=Bunch(E_class="gru", h_dim=80, biGRU=True, layers=1,
                     p_dropout=0.0,
                     # transformer-encoder stretch family (no reference
                     # counterpart; BASELINE.json stretch config)
                     T_args=Bunch(d_model=128, n_layers=2, d_ff=256,
                                  n_heads=4, p_dropout=0.0, bf16=False)),
        G_args=Bunch(
            G_class="gru",
            GRU_args=Bunch(
                p_word_dropout=0.3,
                p_out_dropout=0.3,
                skip_connections=False,
            ),
            T_args=Bunch(d_model=128, n_layers=2, d_ff=256, n_heads=4,
                         p_word_dropout=0.3, p_dropout=0.0, bf16=False),
            deconv_args=Bunch(
                max_seq_len=25,
                num_filters=100,
                kernel_size=4,
                num_deconv_layers=3,
                useRNN=False,
                temperature=1.0,
                use_batch_norm=True,
                num_conv_layers=2,
                add_final_conv_layer=True,
            ),
        ),
        C_args=Bunch(
            min_filter_width=3,
            max_filter_width=5,
            num_filters=100,
            dropout=0.5,
        ),
    )

    # execution knobs. The same flag names as the JAX package, so one
    # command line drives either package. Options the port does not run
    # yet raise NotImplementedError where they are read (ROADMAP.md).
    cfg.hw = Bunch(
        dp=1,                 # data-parallel devices: training, the ranks
                              # of a process group (torchrun, one a
                              # device; 0 = the group's size); sampling and
                              # the server, the first dp devices (0 = all)
        tp=1,                 # tensor parallelism (Megatron) of the
                              # transformer family: ranks on the 'model'
                              # axis of the training mesh
        pp=1,                 # pipeline parallelism (GPipe): stages on its
                              # 'pipe' axis; dp x pp x tp is the group's
                              # size (parallel/dist.py). Sampling and the
                              # server ignore both, as in JAX
        mesh_axis="data",     # the JAX mesh's axis name; no role here
        zero=False,           # ZeRO-1 (phase 1 under dp): Adam's moments
                              # sharded over the ranks
        donate_state=True,    # parse only: buffer donation of jit, no
                              # counterpart in the port
        unroll=50,            # train steps per dispatch, both phases:
                              # runs of up to this many steps (aligned to
                              # the log cadences) replay as one captured
                              # CUDA graph on the card, eagerly on the CPU;
                              # 1 runs each step eagerly
        fused_rounds=True,    # CLaSS: one round = draw, heads, accept, decode
                              # (0: the serial loop)
        rounds_per_dispatch=1,  # CLaSS rounds drawn per launch
        rounds_in_flight=2,   # CLaSS rounds queued ahead of host work
        decode_mode="all",    # "all" beam-decodes every candidate (reference
                              # contract); "accepted" decodes only accepted
                              # ones into fixed-capacity slots
        accept_cap_frac=0.5,  # decode_mode=accepted: slot capacity as a
                              # fraction of the round size
        gen_dtype="float32",  # CLaSS decode compute dtype
        pallas_train="auto",  # "auto" and "on": the device decides, the
                              # CUDA GRU recurrence kernels
                              # (ops/gru_kernel.py) on CUDA tensors, their
                              # plain versions on CPU tensors; "off" raises
        flat_optimizer="auto",  # "on": Adam on one raveled vector
                                # (train/opt.py FlatAdam); "auto", "off":
                                # per-leaf Adam. Keep it across a resume
        pallas_beam="auto",   # kept so JAX command lines parse; "auto" and
                              # "on" both mean the device decides: the
                              # family's CUDA beam kernel (ops/beam_kernel.py,
                              # ops/tfm_beam_kernel.py) on CUDA tensors,
                              # raising outside its scope, and its plain
                              # version on CPU tensors; "off" raises
        beam_canary_floor=0.02,  # CUDA canary: raise when a round's
                                 # unique-sequence ratio drops below this
                                 # floor (0 disables)
        beam_canary_min_rows=256,  # rounds smaller than this are too
                                   # noisy for the uniq-ratio floor
        tfm_lane_budget_gb=4.0,  # transformer rounds: KV-cache budget that
                                 # clamps rounds_per_dispatch
                                 # (pipeline.transformer_dispatch_budget)
        log_hbm_analysis=False,
        profile_dir="",       # non-empty: a torch.profiler trace of a
                              # window of the phase-1 loop written there:
                              # its boundaries (a step or a chunk each) 3-4,
                              # after step 0, the first chunk (its capture)
                              # and one boundary that warms the profiler up
                              # (utils/tracing.PROFILE_SCHEDULE)
        heldout_eval=True,
        log_flush_every=10,
    )

    # dataset switch (cfg.py:304-372)
    cfg.dataset = "amp"       # amp | synthetic

    # synthetic-corpus generation knobs (rebuild-only; the reference ships
    # fixed CSVs). structured=True assembles sequences from per-class motif
    # banks — learnable regularity at reference corpus scale (~100k rows)
    # instead of pure composition noise; see data/synthetic.py
    cfg.synthetic = Bunch(
        n_unlab=600, n_amp=200, n_tox=200, seed=7734, structured=False)

    cfg.amp_sample_prob_factors = Bunch({
        "amp=amp_posc": 20, "amp=amp_posnc": 10,
        "amp=amp_negc": 20, "amp=amp_negnc": 10,
        "tox=tox_posc": 20, "tox=tox_posnc": 10,
        "tox=tox_negc": 20, "tox=tox_negnc": 10,
        "sol": 20,
        "anticancer": 20, "antihyper": 20, "hormone": 20,
    })

    return cfg


# attribute value maps; not part of the scalar flag tree (cfg.py:362-369)
AMP_ATTRIBUTES = [
    ("amp", {"amp_negnc": 0, "amp_negc": 0, "amp_posc": 1, "amp_posnc": 1,
             "na": -1}),
    ("tox", {"tox_negc": 0, "tox_negnc": 0, "tox_posc": 1, "tox_posnc": 1,
             "na": -1}),
    ("sol", {"sol_neg": 0, "sol_pos": 1, "na": -1}),
    ("anticancer", {"anticancer": 1, "na": -1}),
    ("antihyper", {"antihyper": 1, "na": -1}),
    ("hormone", {"cell": 1, "na": -1}),
]

AMP_CSV_FILES = [
    "unlab.csv", "amp_lab.csv", "tox_lab.csv", "sol_lab.csv",
    "anticancer.csv", "antihypertensive.csv", "cell-cell.csv",
]


def _amp_iteratorspecs(factors):
    return {
        "train_vae": dict(subset=["split=train"], weighted_random_sample=True,
                          sample_prob_factors=factors),
        "train_amp_lab": dict(subset=["split=train", "amp"],
                              weighted_random_sample=True,
                              sample_prob_factors=factors),
        "hld_vae": dict(subset=["split=val"], weighted_random_sample=True,
                        sample_prob_factors=factors),
        "hld_unl": dict(subset=["split=val", "^amp"]),
        "hld_amppos": dict(subset=["split=val", "amp=amp_posc,amp_posnc"]),
        "hld_ampneg": dict(subset=["split=val", "amp=amp_negc,amp_negnc"]),
    }


def dataset_spec(cfg):
    """Resolve the active dataset into loader kwargs (cfg.py:308-321).

    Returns a dict with: data_path, csv_files, iteratorspecs, attributes,
    split_seed, fixed_vocab_path.
    """
    factors = dict(cfg.amp_sample_prob_factors)
    if cfg.dataset == "amp":
        data_path = os.environ.get(
            "DATA_PATH_AMP", os.path.join(cfg.datapath, "amp"))
        return dict(
            data_path=data_path,
            csv_files=list(AMP_CSV_FILES),
            iteratorspecs=_amp_iteratorspecs(factors),
            attributes=list(AMP_ATTRIBUTES),
            split_seed=1288,
            fixed_vocab_path=os.path.join(data_path, "vocab.dict"),
        )
    if cfg.dataset == "synthetic":
        # self-contained smoke-test corpus; generated on demand by
        # data/synthetic.py with the same schema as the amp curation output
        data_path = os.path.join(cfg.datapath, "synthetic")
        syn_factors = {
            "amp=amp_posc": 20, "amp=amp_negc": 20,
            "tox=tox_posc": 20, "tox=tox_negc": 20,
        }
        return dict(
            data_path=data_path,
            csv_files=["unlab.csv", "amp_lab.csv", "tox_lab.csv"],
            iteratorspecs=_amp_iteratorspecs(syn_factors),
            attributes=list(AMP_ATTRIBUTES[:2]),
            split_seed=1288,
            fixed_vocab_path="",
            synthetic=dict(cfg.synthetic),
        )
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


# ---------------------------------------------------------------------------
# finalize: derive paths/schedules, apply --tiny/part/phase (cfg.py:75-137)
# ---------------------------------------------------------------------------

def _parse_tristate(name, value):
    """auto/on/off (plus 1/0/true/false/None spellings) -> None/True/False."""
    key = str(value).strip().lower()
    table = {"auto": None, "none": None, "": None,
             "on": True, "1": True, "true": True,
             "off": False, "0": False, "false": False}
    if key not in table:
        raise ValueError(
            f"{name} must be auto/on/off (got {value!r})")
    return table[key]


def check_beam_flag(cfg):
    """hw.pallas_beam may be auto or on; the device picks the beam route.
    "off" asked the JAX package for its XLA arm; the port has no such arm
    on CUDA tensors (the kernel runs or the call raises)."""
    if _parse_tristate("hw.pallas_beam", cfg.hw.pallas_beam) is False:
        raise ValueError(
            "hw.pallas_beam off is not supported: on CUDA tensors the beam "
            "runs in its CUDA kernel; pass --device cpu for the plain "
            "torch version")


def flat_optimizer_enabled(cfg):
    """--hw.flat_optimizer: "on" trains with the flat-vector Adam
    (train/opt.py FlatAdam), "auto" and "off" with the per-leaf one (the
    JAX package's auto is off too)."""
    return bool(_parse_tristate("hw.flat_optimizer",
                                cfg.hw.flat_optimizer))


def check_train_flag(cfg):
    """hw.pallas_train may be auto or on; the device picks the route of the
    training recurrences. "off" asked the JAX package for its XLA scan;
    on CUDA tensors the port runs the kernels or raises."""
    if _parse_tristate("hw.pallas_train", cfg.hw.pallas_train) is False:
        raise ValueError(
            "hw.pallas_train off is not supported: on CUDA tensors the GRU "
            "recurrences run in their CUDA kernels; pass --device cpu for "
            "the plain torch versions")


def finalize(cfg, overrides=None):
    """Derive paths and schedules (the JAX package's finalize without its
    jax-side switches); validates the tristate hardware flags."""
    cfg.savepath = os.path.join(cfg.savepath_toplevel, cfg.runname)
    cfg.tbpath = os.path.join(cfg.tb_toplevel, cfg.runname)

    # re-derive fields default_config() computes FROM n_iter/s_iter, so a
    # CLI/JSON override of those propagates; explicit overrides are kept
    ov = overrides or {}
    rederive = (
        ("full.s_iter", lambda: cfg.vae.n_iter),
        ("vae.beta.start.iter", lambda: cfg.vae.s_iter),
        ("vae.beta.end.iter", lambda: cfg.vae.s_iter + cfg.vae.n_iter // 5),
        ("full.beta.start.iter", lambda: cfg.full.s_iter),
        ("full.beta.end.iter", lambda: cfg.full.s_iter + cfg.full.n_iter),
        ("full.softmax_temp.start.iter", lambda: cfg.full.s_iter),
        ("full.softmax_temp.end.iter",
         lambda: cfg.full.s_iter + cfg.full.n_iter),
    )
    for key, derive in rederive:
        if key not in ov:
            node = cfg
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = derive()

    if cfg.tiny:
        cfg.shared.n_iter = 100
        cfg.shared.cheaplog_every = 10
        cfg.shared.expsvlog_every = 25
        cfg.evals.sample_size = 30
        cfg.shared.batch_size = 5
        cfg.full.s_iter = 100
        cfg.resume_result_json = False

    if cfg.partN > 1:
        if cfg.phase <= 0:
            raise ValueError("split in parts needs per-phase split")
        cfgv = cfg.vae if cfg.phase == 1 else cfg.full
        cfgv.n_iter = cfgv.n_iter // cfg.partN
        cfgv.s_iter += cfg.part * cfgv.n_iter
        cfgv.expsvlog_every = min(cfgv.expsvlog_every, cfgv.n_iter)

    cfg.vae.update(cfg.shared)
    cfg.full.update(cfg.shared)

    if cfg.vocab_path == "auto":
        cfg.vocab_path = os.path.join(cfg.savepath, "vocab.dict")

    chkpt_path = os.path.join(cfg.savepath, "model_{}.npz")
    cfg.vae.chkpt_path = chkpt_path
    cfg.full.chkpt_path = chkpt_path
    if cfg.loadpath == "auto":
        if cfg.part == 0 and cfg.phase != 2:
            cfg.loadpath = ""
        else:
            cfgv = cfg.vae if cfg.phase == 1 else cfg.full
            cfg.loadpath = chkpt_path.format(cfgv.s_iter)

    if cfg.seed and cfg.phase > 0:
        cfg.seed += (cfg.phase - 1) * cfg.partN + cfg.part

    # the port reads these where they are used (no module globals); parse
    # them here so a bad spelling fails before any work starts
    check_beam_flag(cfg)
    check_train_flag(cfg)
    flat_optimizer_enabled(cfg)

    for cfgv, names in ((cfg.vae, (
            ("gen_samples_path", "vae_gen.txt"),
            ("eval_path", "vae_eval.txt"),
            ("fasta_gen_samples_path", "vae_gen.fasta"))), (cfg.full, (
            ("gen_samples_path", "full_gen.txt"),
            ("samez_samples_path", "full_samez.txt"),
            ("posz_samples_path", "full_posz.txt"),
            ("interp_samples_path", "full_interp.txt"),
            ("eval_path", "full_eval.txt"),
            ("pos_eval_path", "full.pos_eval.txt"),
            ("fasta_gen_samples_path", "full_gen.fasta"),
            ("fasta_pos_samples_path", "pos_gen.fasta")))):
        for field, fn in names:
            cfgv[field] = os.path.join(cfg.savepath, fn)
    return cfg


def parse_and_finalize(argv=None, extra_args=None, cfg=None):
    """Standard CLI entry: build default tree, parse flags, finalize.

    Returns (cfg, args, overrides).
    """
    import argparse

    cfg = cfg if cfg is not None else default_config()
    parser = argparse.ArgumentParser(
        description="Override config float & string values")
    fill_parser(parser, cfg)
    if extra_args:
        for flag, kwargs in extra_args:
            parser.add_argument(flag, **kwargs)
    args = parser.parse_args(argv)
    overrides = {}
    if getattr(args, "config_json", None):
        overrides.update(override_from_json(cfg, args.config_json))
    overrides.update(override_from_args(cfg, args))
    finalize(cfg, overrides)
    return cfg, args, overrides
