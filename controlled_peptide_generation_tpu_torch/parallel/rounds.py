"""The device list a CLaSS round runs over: the counterpart of the mesh of
the JAX package's ``dp_fused_round`` and ``dp_rejection_round``
(``parallel/mesh.py:213, 271`` there).

Every round runs over a ``Shards``: a device list and the params
replicated on each of its devices, one entry for one device. The round's
global draws are split n / D per device (``split``), every device's work
is enqueued before any result is read, and the outputs are joined in
device order on the draws' device (``join``); ``latent/fused.py`` and
``latent/class_sampler.py`` compose their rounds from these pieces. The
JAX round runs in one process over that process's devices, with no
collective but the accepted-only compaction; so does this one. The beams
B1 and B3 are batch-invariant, so tokens, accept, idx and valid equal the
one-device round's on the same draws, bit for bit; z and the scores come
from products whose last bits may depend on the rows computed together.

A device list may name one device more than once (two shards on one
card): each shard is its own launches, in device order.
"""

from typing import NamedTuple

import torch


class Shards(NamedTuple):
    """A round's device list and the params replicated on each."""
    devices: list
    replicas: list


def devices_for(cfg, device):
    """The device list of ``hw.dp`` (0: every visible device) on
    ``device``'s type: the first ``hw.dp`` CUDA devices (more than
    ``torch.cuda.device_count()`` raises, as the JAX package's
    ``get_mesh`` asserts), or ``hw.dp`` entries of the CPU."""
    n = int(cfg.hw.get("dp", 1))
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * max(n, 1)
    have = torch.cuda.device_count()
    n = n or have
    if n > have:
        raise ValueError(f"hw.dp {n}: need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def to(tree, dev):
    """A tree of tensors (dicts, lists, tuples, NamedTuples) on ``dev``;
    other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to(v, dev) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _device_of(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    for v in (tree.values() if isinstance(tree, dict)
              else tree if isinstance(tree, (list, tuple)) else ()):
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


def shards_of(params, devices=None):
    """``params`` replicated over ``devices`` (default: the one device
    they lie on); a device named twice shares one copy."""
    if devices is None:
        devices = [_device_of(params) or torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = to(params, dev)
    return Shards(devices, [copies[dev] for dev in devices])


def check(n, devices, capacity=None):
    """A round of ``n`` candidates (``capacity`` decode slots) must split
    evenly over the devices."""
    D = len(devices)
    if n % D:
        raise ValueError(f"round size {n} must divide over {D} devices")
    if capacity is not None and capacity % D:
        raise ValueError(f"decode capacity {capacity} must divide over {D} "
                         f"devices")


def split(x, devices):
    """``x`` (a tensor, or a NamedTuple of them) in len(devices) equal
    blocks of rows, block i on devices[i]."""
    if isinstance(x, tuple):
        return [type(x)(*f) for f in zip(*(split(t, devices) for t in x))]
    b = x.shape[0] // len(devices)
    return [x[i * b:(i + 1) * b].to(d) for i, d in enumerate(devices)]


def join(parts, home):
    """The devices' blocks in device order on ``home`` (one block as it
    is)."""
    if len(parts) == 1:
        return parts[0].to(home)
    return torch.cat([p.to(home) for p in parts])
