"""The benchmark's weights: one tree made on the device from the seed, in
two draws (all uniform leaves, then all normal ones), handed to the
program and, cloned, to the reference."""

import torch

from .reference.common import PAD
from .reference.models import param_spec, set_leaf


def make(cfg, seed, device, gain=1.0):
    """The parameter tree of configuration ``cfg`` from ``seed``: every
    leaf as ``reference.models.param_spec`` states it, the linear maps'
    weight matrices (leaves named "w" drawn uniform) scaled by ``gain``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    spec = param_spec(cfg)
    uni = [s for s in spec if s[2] == "uniform"]
    nor = [s for s in spec if s[2] in ("normal", "embedding")]
    numel = [int(torch.Size(s[1]).numel()) for s in uni]
    u = torch.rand((sum(numel),), generator=gen, device=device)
    n = torch.randn((sum(int(torch.Size(s[1]).numel()) for s in nor),),
                    generator=gen, device=device)
    tree, at = {}, 0
    for (path, shape, _, bound), k in zip(uni, numel):
        scale = bound * (gain if path[-1] == "w" else 1.0)
        set_leaf(tree, path, (2.0 * u[at:at + k] - 1.0).reshape(shape) * scale)
        at += k
    at = 0
    for path, shape, kind, bound in nor:
        k = int(torch.Size(shape).numel())
        leaf = n[at:at + k].reshape(shape) * bound
        if kind == "embedding":
            leaf[PAD] = 0.0
        set_leaf(tree, path, leaf)
        at += k
    for path, shape, kind, _ in spec:
        if kind in ("ones", "zeros"):
            set_leaf(tree, path, (torch.ones if kind == "ones" else
                                  torch.zeros)(shape, device=device))
    return tree


def clone(tree):
    """A deep copy of nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()
