"""Data-parallel steps of the port from injected inputs, run on every rank
of a process group: how the tests hold the DP trainers against the JAX
package's DP steps and the port's one-device step on the global batch.

    from controlled_peptide_generation_tpu_torch.parallel import dist
    from controlled_peptide_generation_tpu_torch.tools import dp_check
    dist.spawn(dp_check.run, 2, "cases.pkl", "out_dir")

``cases.pkl`` is a pickled list of cases (dicts of numpy arrays, lists
and flags, ``kind`` one of ``CASES``); each rank writes the list of
their results to ``out_dir/rank<r>.pkl``. A case's function also runs
without a group (``shard=None``): the one-device step on the same
inputs.
"""

import os
import pickle

import numpy as np
import torch

from .. import config as C
from ..models.rnn_vae import build_model
from ..parallel import collectives
from ..parallel.collectives import Shard
from ..train import checkpoints
from ..train.opt import _reduced
from ..train.train_full import FullStep, group_grads
from ..train.train_vae import make_train_step


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(v) for v in x]
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _flat_np(tree):
    return {checkpoints.keystr(p): v.detach().numpy().copy()
            for p, v in checkpoints.flatten(tree).items()}


def _setup(case):
    cfg, _, _ = C.parse_and_finalize(list(case["argv"]))
    model = build_model(cfg.model, n_vocab=case["V"],
                        max_seq_len=case["T"])
    params = checkpoints.params_from_jax(case["params"])
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)
    rf = None if case.get("rf") is None else tuple(_t(a) for a in case["rf"])
    return cfg, model, params, rf


def train_case(case, shard=None):
    """Phase-1 steps it = 0, 1, ... on case["steps"] ((text, draws) of the
    global batch each); under case["zero"] ZeRO-1's step, under
    case["flat"] the flat Adam. Returns the params, each step's metrics
    and the (full) Adam state; with case["save"] rank 0 writes the
    checkpoint there."""
    cfg, model, params, rf = _setup(case)
    step, opt = make_train_step(model, cfg.vae, cfg.losses, rf,
                                case.get("flat", False), shard,
                                case.get("zero", False))
    state = opt.init(params)
    metrics = []
    for it, (text, draws) in enumerate(case["steps"]):
        m = step(params, state, _t(text), it, _t(draws))
        metrics.append({k: float(v) for k, v in m.items()})
    if case.get("zero") and shard is not None:
        state = opt.full_state(params, state)
    if case.get("save") and (shard is None or shard.rank == 0):
        checkpoints.save(case["save"], params, state,
                         step=len(case["steps"]))
    return {"params": _flat_np({"params": params}), "metrics": metrics,
            "opt": _flat_np({k: v for k, v in state.items()})}


def full_case(case, shard=None):
    """Phase-2 iterations it = 0, 1, ... on case["steps"] ((text,
    lab_text, lab_y, draws) of the global batches each). Returns the
    params and each iteration's metrics, and, first, each sub-loss's group
    gradients at the starting params, averaged over the ranks."""
    cfg, model, params, rf = _setup(case)
    step = FullStep(model, cfg.full, cfg.losses, rf, shard)
    text, lab_text, lab_y, draws = case["steps"][0]
    text, lab_text, lab_y, draws = (_t(text), _t(lab_text), _t(lab_y),
                                    _t(draws))
    beta, temp = (torch.tensor(v) for v in step.schedule(0))
    grads = {}
    with collectives.active(shard):
        for name, (loss, _), groups in (
                ("vae", step.vae_loss(params, text, beta, draws["vae"]),
                 ("E", "G")),
                ("attr", step.g_attr_loss(params, temp, draws["attr"]),
                 ("G",)),
                ("clf", step.c_loss(params, lab_text, lab_y, temp,
                                    draws["clf"]), ("C",))):
            for g, tree in group_grads(loss, params, groups).items():
                flat = checkpoints.flatten(tree)
                if shard is not None:
                    flat = _reduced(flat, shard.mean_)
                grads[f"{name}/{g}"] = {checkpoints.keystr(p): v.numpy()
                                        for p, v in flat.items()}
    opt_states = step.init(params)
    metrics = []
    for it, (text, lab_text, lab_y, draws) in enumerate(case["steps"]):
        m = step(params, opt_states, _t(text), _t(lab_text), _t(lab_y), it,
                 _t(draws))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": _flat_np({"params": params}), "metrics": metrics, "grads": grads}


def gather_case(case, shard):
    """The gradient of sum(z_all ** 2) with respect to the rank's rows of
    z through ``Shard.gather`` and through ``torch.distributed.nn``'s
    all_gather (the global z: case["z"])."""
    from torch.distributed.nn.functional import all_gather
    z = _t(case["z"])
    out = {}
    for name, gather in (("own_rows", shard.gather),
                         ("torch_nn", lambda x: torch.cat(all_gather(x)))):
        local = shard.rows(z).clone().requires_grad_(True)
        (g,) = torch.autograd.grad((gather(local) ** 2).sum(), local)
        out[name] = g.numpy()
    return out


def main_case(case, shard):
    """``main.main(case["argv"])`` on every rank (its output files are
    the result)."""
    from .. import main
    main.main(list(case["argv"]))
    return {}


def refusal_case(case, shard):
    """The message ``data_parallel`` raises for case["argv"] (None when
    it raises nothing)."""
    from ..parallel import dist as pdist
    cfg, _, _ = C.parse_and_finalize(list(case["argv"]))
    try:
        pdist.data_parallel(cfg, case.get("batch_sizes", ()))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


CASES = {"train": train_case, "full": full_case, "gather": gather_case,
         "main": main_case, "refusal": refusal_case}


def run(cases_path, out_dir):
    """Every case of the pickled list on this rank; writes their results
    to ``out_dir/rank<r>.pkl``."""
    with open(cases_path, "rb") as fh:
        cases = pickle.load(fh)
    shard = Shard()
    results = [CASES[c["kind"]](c, shard) for c in cases]
    with open(os.path.join(out_dir, f"rank{shard.rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)
