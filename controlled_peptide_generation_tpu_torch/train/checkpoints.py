"""Checkpoint IO in the JAX package's format.

A checkpoint is one ``model_<iter>.npz`` whose keys are jax keystr paths
of the state pytree, e.g. ``"['params']['dec']['gru']['wi']"``. The port
keeps parameters as nested dicts of tensors with the same names, so the
path of a leaf is the chain of its dict keys.
"""

import os
import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^']*)'\]")


def keystr(path):
    """('params', 'dec', 'gru', 'wi') -> "['params']['dec']['gru']['wi']"."""
    return "".join(f"['{p}']" for p in path)


def parse_keystr(key):
    """Inverse of keystr for dict-only paths; raises on other path kinds
    (optimizer NamedTuple fields, list indices)."""
    parts = _KEY_PART.findall(key)
    if keystr(parts) != key:
        raise ValueError(f"not a dict-only key path: {key!r}")
    return tuple(parts)


def flatten(tree, prefix=()):
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def params_from_jax(flat, device="cpu"):
    """Carry the JAX package's parameters across.

    flat: {keystr or path tuple: numpy array}, e.g. the leaves of a JAX
    ``{'params': params}`` checkpoint as numpy arrays. Returns the nested
    dict of tensors under 'params' (or the whole tree when no key starts
    with 'params'). Values are copied bit for bit."""
    tree = {}
    for key, arr in flat.items():
        path = parse_keystr(key) if isinstance(key, str) else tuple(key)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return tree.get("params", tree)


def save(path, params):
    """Write ``{'params': params}`` as a JAX-format npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {keystr(("params",) + p): v.detach().cpu().numpy()
            for p, v in flatten(params).items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    os.replace(tmp, path)


def load(path, device="cpu"):
    """Read the ``['params']...`` leaves of a JAX-format npz (optimizer
    state and other keys are ignored) into a nested dict of tensors."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files
                if k.startswith("['params']")}
    if not flat:
        raise KeyError(f"checkpoint {path} holds no ['params'] leaves")
    return params_from_jax(flat, device)


def latest_step(savepath, pattern=r"model_(\d+)\.npz$"):
    """Highest iteration with a saved checkpoint, or None."""
    if not os.path.isdir(savepath):
        return None
    steps = [int(m.group(1)) for name in os.listdir(savepath)
             if (m := re.search(pattern, name))]
    return max(steps) if steps else None
