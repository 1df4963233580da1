"""Tensor- and pipeline-parallel steps of the port from injected inputs,
run on every rank of a process group: how the tests hold the TP, PP and
3D trainers against the JAX package's steps and the port's one-device
step on the same inputs.

    from controlled_peptide_generation_tpu_torch.parallel import dist
    from controlled_peptide_generation_tpu_torch.tools import mp_check
    dist.spawn(mp_check.run, 4, "cases.pkl", "out_dir")

``cases.pkl`` is a pickled list of cases (dicts of numpy arrays, lists
and flags, ``kind`` one of ``CASES``, ``mesh`` the (dp, pp, tp) shape
of the group's ranks); each rank writes the list of their results to
``out_dir/rank<r>.pkl``. A case's function also runs without a group
(``mesh=None``): the one-device step on the same inputs. Params and Adam
moments come back gathered in full, keyed as in a checkpoint.
"""

import os
import pickle

import torch

from ..parallel import collectives
from ..parallel import dist as pdist
from ..parallel import pp as pp_mod
from ..train import checkpoints
from ..train.train_full import FullStep, group_grads
from ..train.train_vae import make_train_step
from .dp_check import _setup, _t


def _state_np(tree):
    """{checkpoint key: array} of a train state's leaves."""
    return {checkpoints.state_keystr(p): v.detach().numpy().copy()
            for p, v in checkpoints.flatten(tree).items()}


def _parts(case, mesh):
    """(cfg, model, params, rf) of ``dp_check._setup``, the model wrapped
    and the params cut to this rank's parts on a mesh."""
    cfg, model, params, rf = _setup(case)
    if mesh is not None:
        model = mesh.wrap(model)
        params = mesh.shard(params)
        for leaf in checkpoints.flatten(params).values():
            leaf.requires_grad_(True)
    return cfg, model, params, rf


def _full(mesh, params, opt=None):
    if mesh is None:
        return params, opt
    return mesh.gather(params), (None if opt is None
                                 else mesh.gather_opt(opt))


def train_case(case, mesh=None):
    """Phase-1 steps it = 0, 1, ... on case["steps"] ((text, draws) of the
    global batch each). Returns, after each step, the params and the Adam
    state in full and the step's metrics; with case["save"] rank 0 writes
    the last step's checkpoint there."""
    cfg, model, params, rf = _parts(case, mesh)
    shard = None if mesh is None else mesh.data
    step, opt = make_train_step(model, cfg.vae, cfg.losses, rf, False,
                                shard, False, mesh)
    state = opt.init(params)
    out = []
    for it, (text, draws) in enumerate(case["steps"]):
        m = step(params, state, _t(text), it, _t(draws))
        p_full, o_full = _full(mesh, params, state)
        out.append({"state": _state_np({"params": p_full, "opt": o_full}),
                    "metrics": {k: float(v) for k, v in m.items()}})
    if case.get("save") and pdist.is_writer():
        checkpoints.save(case["save"], p_full, o_full,
                         step=len(case["steps"]))
    return out


def full_case(case, mesh=None):
    """Phase-2 iterations it = 0, 1, ... on case["steps"] ((text,
    lab_text, lab_y, draws) of the global batches each). Returns, first,
    each sub-loss's group gradients at the starting params in full, then
    the params in full and the metrics after each iteration."""
    cfg, model, params, rf = _parts(case, mesh)
    shard = None if mesh is None else mesh.data
    step = FullStep(model, cfg.full, cfg.losses, rf, shard, mesh)
    text, lab_text, lab_y, draws = (_t(x) for x in case["steps"][0])
    beta, temp = (torch.tensor(v) for v in step.schedule(0))
    grads = {}
    with collectives.active(shard):
        for name, (loss, _), names in (
                ("vae", step.vae_loss(params, text, beta, draws["vae"]),
                 ("E", "G")),
                ("attr", step.g_attr_loss(params, temp, draws["attr"]),
                 ("G",)),
                ("clf", step.c_loss(params, lab_text, lab_y, temp,
                                    draws["clf"]), ("C",))):
            for g, tree in group_grads(loss, params, names).items():
                if shard is not None:
                    tree = checkpoints.unflatten({
                        p: shard.mean_(v.clone()) for p, v in
                        checkpoints.flatten(tree).items()})
                tree = _full(mesh, tree)[0]
                grads[f"{name}/{g}"] = {
                    checkpoints.keystr(p): v.detach().numpy() for p, v in
                    checkpoints.flatten(tree).items()}
    opt_states = step.init(params)
    out = []
    for it, (text, lab_text, lab_y, draws) in enumerate(case["steps"]):
        m = step(params, opt_states, _t(text), _t(lab_text), _t(lab_y), it,
                 _t(draws))
        out.append({"state": _state_np({"params": _full(mesh, params)[0]}),
                    "metrics": {k: float(v) for k, v in m.items()}})
    return {"grads": grads, "steps": out}


def blocks_case(case, mesh):
    """``pp.make_blocks_apply`` over the pipe axis on a block stack
    (case["blocks"], the full list as a checkpoint's flat dict), x and a
    mask, for each n_micro of case["n_micro"]: the output and the
    gradients of sum(out * case["cot"]) with respect to x and every block
    leaf (in full)."""
    local = mesh.shard(checkpoints.params_from_jax(case["blocks"]))
    out = {}
    for n_micro in case["n_micro"]:
        apply = pp_mod.make_blocks_apply(mesh.pipe, case["n_heads"], n_micro,
                                         mesh.model)
        x = _t(case["x"]).requires_grad_(True)
        leaves = checkpoints.flatten(local)
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        y = apply(local["blocks"], x, _t(case["mask"]))
        g = torch.autograd.grad((y * _t(case["cot"])).sum(),
                                [x] + list(leaves.values()))
        g_blocks = mesh.gather(checkpoints.unflatten(dict(zip(leaves,
                                                              g[1:]))))
        out[n_micro] = {
            "y": y.detach().numpy(), "dx": g[0].numpy(),
            "dblocks": {checkpoints.keystr(p): v.numpy() for p, v in
                        checkpoints.flatten(g_blocks).items()}}
    return out


def main_case(case, mesh):
    """``main.main(case["argv"])`` on every rank (its output files are
    the result)."""
    from .. import main
    main.main(list(case["argv"]))
    return {}


def refusal_case(case, mesh):
    """The message ``parallel_layout`` raises for case["argv"] (None when
    it raises nothing)."""
    from .. import config as C
    cfg, _, _ = C.parse_and_finalize(list(case["argv"]))
    try:
        pdist.parallel_layout(cfg, case.get("batch_sizes", ()))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


CASES = {"train": train_case, "full": full_case, "blocks": blocks_case,
         "main": main_case, "refusal": refusal_case}


def run(cases_path, out_dir):
    """Every case of the pickled list on this rank, each on the mesh of
    its ``mesh`` shape (none for ``main`` and ``refusal``, whose trainers
    make their own); writes their results to ``out_dir/rank<r>.pkl``."""
    with open(cases_path, "rb") as fh:
        cases = pickle.load(fh)
    results = []
    for c in cases:
        mesh = pdist.Mesh(*c["mesh"]) if "mesh" in c else None
        results.append(CASES[c["kind"]](c, mesh))
    with open(os.path.join(out_dir, f"rank{pdist.rank()}.pkl"), "wb") as fh:
        pickle.dump(results, fh)
