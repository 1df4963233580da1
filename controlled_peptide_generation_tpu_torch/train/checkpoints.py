"""Checkpoint IO in the JAX package's format.

A checkpoint is one ``model_<iter>.npz`` whose keys are jax keystr paths
of the train-state pytree ``{'params', 'opt', 'step'}``:

* parameters: ``"['params']['dec']['gru']['wi']"``; the port keeps them as
  nested dicts (and lists) of tensors with the same names, so a leaf's path
  is the chain of its dict keys and list indices. A list index is an int
  in the port's path and ``[i]`` in the file: the transformer's blocks are
  ``"['params']['dec']['blocks'][0]['qkv']['w']"``, path
  ``('params', 'dec', 'blocks', 0, 'qkv', 'w')``;
* the Adam state of ``optax.chain(clip_by_global_norm, adam)``:
  ``"['opt'][1][0].count"``, ``"['opt'][1][0].mu['emb']['w']"``,
  ``"['opt'][1][0].nu[...]"``; in the port ``{'count', 'mu', 'nu'}``
  (``train/opt.py`` ClipAdam), under the path ``('opt', 'mu', 'emb',
  'w')``;
* or the flat-vector Adam's (``--hw.flat_optimizer on``, the JAX
  package's ``FlatAdamState``): ``"['opt'].m"``, ``"['opt'].v"`` (one
  vector each, over the file's ``['params']`` leaves in ``ravel_order``)
  and ``"['opt'].count"``; in the port ``{'m', 'v', 'count'}`` (FlatAdam);
* ``"['step']"``, the iteration it was saved at.

A phase-2 file is ``{'params', 'step'}`` with the classifier's
parameters under ``['params']['clf']`` and no optimizer state, as the JAX
package's ``train_full`` writes it; ``load_params`` fills a template
from a file non-strictly (a phase-1 file has no classifier).

A phase-1 file the port writes holds no classifier parameters (no
gradient reaches them in phase 1); the JAX package's non-strict loader
keeps its own values for those. The flat m and v the port writes run
over every leaf of the JAX package's train state in its ravel order, the
classifier's included (their segments are 0, as in a JAX phase-1 run:
``models/classifier.classifier_shapes`` is the JAX package's classifier
layout), so a JAX
resume with its full template loads them. Reading, the port cuts its own
leaves' segments out of a file's vectors: a JAX file's, this writer's, or
one written before the classifier's segments were (vectors over the
port's leaves only). A resume that flips the layout raises a ValueError
naming ``--hw.flat_optimizer`` (``check_opt_layout``, the JAX package's
``_check_opt_layout``).
"""

import os
import re

import numpy as np
import torch

from ..models.classifier import classifier_shapes

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_OPTAX_ADAM = "['opt'][1][0]"
_OPTAX_LEAF = re.compile(r"^\['opt'\]\[1\]\[0\]\.(count|mu|nu)(.*)$")
_FLAT_OPT = "['opt']"
_FLAT_LEAF = re.compile(r"^\['opt'\]\.(count|m|v)$")
# the layouts' fingerprints in key paths (NamedTuple fields are ".name")
_FLAT_OPT_PAT = re.compile(r"\.(m|v)$")
_OPTAX_OPT_PAT = re.compile(r"\.(mu|nu)(\W|$)")


def keystr(path):
    """('params', 'dec', 'blocks', 0, 'w') ->
    "['params']['dec']['blocks'][0]['w']": a str is a dict key, an int a
    list index."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def parse_keystr(key):
    """Inverse of keystr for paths of dict keys and list indices; raises
    on other path kinds."""
    parts = tuple(int(i) if k == "" and i else k
                  for k, i in _KEY_PART.findall(key))
    if keystr(parts) != key:
        raise ValueError(f"not a path of dict keys and list indices: "
                         f"{key!r}")
    return parts


def state_keystr(path, flat=False):
    """A path of the port's train state -> its key in the file; ``flat``
    for the flat-vector Adam's state (``('opt', 'm')`` ->
    ``"['opt'].m"``)."""
    if path[0] == "opt":
        if flat:
            return f"{_FLAT_OPT}.{path[1]}"
        return f"{_OPTAX_ADAM}.{path[1]}" + keystr(path[2:])
    return keystr(path)


def parse_state_keystr(key):
    """Inverse of state_keystr (either layout)."""
    m = _OPTAX_LEAF.match(key) or _FLAT_LEAF.match(key)
    if m:
        rest = m.group(2) if m.re is _OPTAX_LEAF else ""
        return ("opt", m.group(1)) + parse_keystr(rest)
    return parse_keystr(key)


def is_flat(opt_state):
    """True for the flat-vector Adam's state ({'m', 'v', 'count'})."""
    return opt_state is not None and "m" in opt_state


def ravel_order(tree):
    """The leaves' paths in the order ``jax.flatten_util.ravel_pytree``
    concatenates them: dict keys sorted, list entries by index (a path
    compares part by part; siblings are all dict keys or all indices)."""
    return sorted(flatten(tree))


def check_opt_layout(path, tmpl_keys, file_keys):
    """Raise a ValueError naming --hw.flat_optimizer when the file's Adam
    layout (flat vector or per leaf) is not the template's: a resume that
    flipped the flag would otherwise fail on a missing key or reset the
    moments without a word."""
    t_flat = any(_FLAT_OPT_PAT.search(k) for k in tmpl_keys)
    t_optax = any(_OPTAX_OPT_PAT.search(k) for k in tmpl_keys)
    f_flat = any(_FLAT_OPT_PAT.search(k) for k in file_keys)
    f_optax = any(_OPTAX_OPT_PAT.search(k) for k in file_keys)
    if ((t_flat and not t_optax and f_optax and not f_flat)
            or (t_optax and not t_flat and f_flat and not f_optax)):
        stored = "per-leaf" if f_optax else "flat-vector"
        expected = "flat-vector" if t_flat else "per-leaf"
        raise ValueError(
            f"checkpoint {path} stores the {stored} Adam state but this run "
            f"expects the {expected} layout: --hw.flat_optimizer was "
            f"flipped across a resume. Resume with the original "
            f"--hw.flat_optimizer setting, or train from scratch.")


def _clf_sizes(emb_dim, c_args):
    return {("clf",) + p: int(np.prod(s))
            for p, s in classifier_shapes(emb_dim, **(c_args or {})).items()}


def flatten(tree, prefix=()):
    """Nested dicts and lists -> {path tuple: leaf} (a list index is an
    int in the path)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat):
    """{path tuple: leaf} -> nested dicts, and lists where a node's keys
    are the ints 0..n-1."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out


def state_from_jax(flat, device="cpu"):
    """The JAX package's train state as the port's nested dict.

    flat: {keystr or path tuple: numpy array}, e.g. the leaves of a JAX
    checkpoint. Returns {'params': ..., 'opt': {'count', 'mu', 'nu'},
    'step': ...} with the parts the file holds. Values are copied bit for
    bit."""
    out = {}
    for key, arr in flat.items():
        path = parse_state_keystr(key) if isinstance(key, str) else tuple(key)
        out[path] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return unflatten(out)


def params_from_jax(flat, device="cpu"):
    """The parameters of a JAX train state (``state_from_jax``'s 'params',
    or the whole tree when no key starts with 'params')."""
    tree = state_from_jax(flat, device)
    return tree.get("params", tree)


def _jax_flat_vector(params, vec, c_args):
    """A flat vector over ``params``' leaves (ravel order) -> the JAX
    train state's: zeros at the classifier's segments."""
    if "clf" in params:
        return vec
    own = {p: t.numel() for p, t in flatten(params).items()}
    sizes = {**own, **_clf_sizes(params["emb"]["w"].shape[1], c_args)}
    parts, at = [], 0
    for p in sorted(sizes):
        if p in own:
            parts.append(vec[at:at + own[p]])
            at += own[p]
        else:
            parts.append(torch.zeros(sizes[p], dtype=vec.dtype,
                                     device=vec.device))
    return torch.cat(parts)


def save(path, params, opt_state=None, step=None, c_args=None):
    """Write ``{'params': params}``, plus the Adam state and the step when
    given, as a JAX-format npz. A flat Adam state's m and v are written
    over the JAX train state's leaves, the classifier's (shapes from
    ``c_args``, ``cfg.model.C_args``) as zeros."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
        if is_flat(opt_state):
            state["opt"] = dict(opt_state, **{
                k: _jax_flat_vector(params, opt_state[k], c_args)
                for k in ("m", "v")})
    flat = {state_keystr(p, is_flat(opt_state)): v.detach().cpu().numpy()
            for p, v in flatten(state).items()}
    if step is not None:
        flat[keystr(("step",))] = np.asarray(step, np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    os.replace(tmp, path)


def _read(path, keep):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if keep(k)}


def load(path, device="cpu"):
    """Read the ``['params']...`` leaves of a JAX-format npz (optimizer
    state and other keys are ignored) into a nested dict of tensors."""
    flat = _read(path, lambda k: k.startswith("['params']"))
    if not flat:
        raise KeyError(f"checkpoint {path} holds no ['params'] leaves")
    return params_from_jax(flat, device)


def _own_segments(path, data, params, c_args=None):
    """The file's flat m and v cut down to ``params``' leaves: the file's
    vectors run over its own ``['params']`` leaves in ravel order, and
    over the classifier's where the file holds no classifier but its
    vectors are longer (the port's writer)."""
    sizes = {parse_keystr(k)[1:]: data[k].size for k in data
             if k.startswith("['params']")}
    n_file = sum(sizes.values())
    key_m = f"{_FLAT_OPT}.m"
    if (key_m in data and data[key_m].size > n_file
            and not any(p[0] == "clf" for p in sizes)):
        emb = data[keystr(("params", "emb", "w"))]
        sizes.update(_clf_sizes(emb.shape[1], c_args))
    offsets, at = {}, 0
    for p in sorted(sizes):
        offsets[p] = at
        at += sizes[p]
    for name in ("m", "v"):
        key = f"{_FLAT_OPT}.{name}"
        if key not in data:
            continue
        vec = data[key]
        if vec.shape != (at,):
            raise ValueError(f"{path}: {key} has shape {vec.shape}, but the "
                             f"file's parameters ravel to ({at},)")
        parts = []
        for p in ravel_order(params):
            if p not in offsets:
                raise ValueError(f"{path}: no {keystr(('params',) + p)} to "
                                 f"place {key} by")
            parts.append(vec[offsets[p]:offsets[p] + sizes[p]])
        data[key] = np.concatenate(parts) if parts else vec[:0]
    return data


def load_params(path, params, device="cpu"):
    """Copies of ``params`` (nested dicts and lists of tensors) filled from
    the file's ``['params']`` leaves by key path; leaves the file lacks
    keep the given values and its other keys are ignored (the JAX
    package's ``strict=False``). A leaf of another shape raises."""
    stored = flatten(load(path, device))
    out = {}
    for p, leaf in flatten(params).items():
        if p in stored:
            if stored[p].shape != leaf.shape:
                raise ValueError(
                    f"{path}: {keystr(('params',) + p)} has shape "
                    f"{tuple(stored[p].shape)}, expected {tuple(leaf.shape)}")
            leaf = stored[p].to(leaf.dtype)
        out[p] = leaf.detach().clone()
    return unflatten(out)


def load_train_state(path, params, opt_state, device="cpu", c_args=None):
    """Fill copies of ``params`` and ``opt_state`` (the port's nested
    dicts; the Adam state of either layout) from the file by key path.
    Leaves the file lacks keep the given values and keys the file has
    beyond them are ignored (the JAX package's ``strict=False``: e.g. the
    classifier's parameters and moments). A file whose Adam layout is not
    ``opt_state``'s raises a ValueError naming --hw.flat_optimizer.
    ``c_args`` (``cfg.model.C_args``) sizes the classifier's segments of
    a port-written flat state. Returns (params, opt_state)."""
    flat = is_flat(opt_state)
    data = _read(path, lambda k: k.startswith(("['params']", "['opt']")))
    want = flatten({"params": params, "opt": opt_state})
    check_opt_layout(path, {state_keystr(p, flat) for p in want}, set(data))
    if flat:
        data = _own_segments(path, data, params, c_args)
    stored = flatten(state_from_jax(data, device))
    out = {}
    for p, leaf in want.items():
        if p in stored:
            if stored[p].shape != leaf.shape:
                raise ValueError(
                    f"{path}: {state_keystr(p, flat)} has shape "
                    f"{tuple(stored[p].shape)}, expected {tuple(leaf.shape)}")
            leaf = stored[p].to(leaf.dtype)
        out[p] = leaf.clone()
    tree = unflatten(out)
    return tree["params"], tree["opt"]


def latest_step(savepath, pattern=r"model_(\d+)\.npz$"):
    """Highest iteration with a saved checkpoint, or None."""
    if not os.path.isdir(savepath):
        return None
    steps = [int(m.group(1)) for name in os.listdir(savepath)
             if (m := re.search(pattern, name))]
    return max(steps) if steps else None
