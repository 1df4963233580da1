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
  (``train/opt.py``), under the path ``('opt', 'mu', 'emb', 'w')``;
* ``"['step']"``, the iteration it was saved at.

The port writes no classifier parameters (no gradient reaches them in
phase 1) and no moments for them; the JAX package's non-strict loader
keeps its own values for those.
"""

import os
import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_OPTAX_ADAM = "['opt'][1][0]"
_OPTAX_LEAF = re.compile(r"^\['opt'\]\[1\]\[0\]\.(count|mu|nu)(.*)$")
_FLAT_ADAM = re.compile(r"^\['opt'\].*\.(m|v)$")


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


def state_keystr(path):
    """A path of the port's train state -> its key in the file."""
    if path[0] == "opt":
        return f"{_OPTAX_ADAM}.{path[1]}" + keystr(path[2:])
    return keystr(path)


def parse_state_keystr(key):
    """Inverse of state_keystr."""
    if _FLAT_ADAM.match(key):
        raise ValueError(
            f"{key!r} is the flat-vector Adam state of --hw.flat_optimizer "
            f"on, which the port does not run")
    m = _OPTAX_LEAF.match(key)
    if m:
        return ("opt", m.group(1)) + parse_keystr(m.group(2))
    return parse_keystr(key)


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


def save(path, params, opt_state=None, step=None):
    """Write ``{'params': params}``, plus the Adam state and the step when
    given, as a JAX-format npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
    flat = {state_keystr(p): v.detach().cpu().numpy()
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


def load_train_state(path, params, opt_state, device="cpu"):
    """Fill copies of ``params`` and ``opt_state`` (the port's nested
    dicts) from the file by key path. Leaves the file lacks keep the given
    values and keys the file has beyond them are ignored (the JAX
    package's ``strict=False``: e.g. the classifier's parameters and
    moments). Returns (params, opt_state)."""
    stored = flatten(state_from_jax(_read(
        path, lambda k: k.startswith(("['params']", "['opt']"))), device))
    want = flatten({"params": params, "opt": opt_state})
    out = {}
    for p, leaf in want.items():
        if p in stored:
            if stored[p].shape != leaf.shape:
                raise ValueError(
                    f"{path}: {state_keystr(p)} has shape "
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
