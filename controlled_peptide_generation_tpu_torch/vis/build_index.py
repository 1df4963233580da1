"""Latent states dump and exact inner-product index.

``extract_from_dataset`` encodes up to ``max_examples`` rows of each split,
drawn by the weighted subset iterators at the training batch size, with
z = mu (the JAX package's ``sample_z="max"``), and writes the six arrays
of H5_SETS per split, as the JAX package's ``vis/build_index.py`` does:

* always ``states_{split}_{iter}.npz``, which needs only numpy;
* where h5py imports, also ``states_{split}_{iter}.h5`` with the JAX
  schema (gzip 9, resizable rows, the same dtypes), so the JAX package's
  ``read_states`` and ``sample_pipeline`` read a dump the port wrote.

``read_states`` takes the ``.h5`` where it exists and h5py imports, the
``.npz`` otherwise; the two hold identical arrays. mu, logvar and z are
stored as float16, rounded on the host by numpy's ``astype``.

``LatentIndex`` (``index_{iter}.npz``, schema 1, the JAX package's
format) is one product and a top-k on the device: at z_dim 100 and up to
1e6 rows an exact search needs no approximate index.
"""

import logging
import os
import time

import numpy as np
import torch

from ..train import checkpoints

LOG = logging.getLogger("GenerationAPI")

H5_SETS = ("src", "z", "mu", "logvar", "label", "split")
SPLIT_ENCODING = {"train": 0, "val": 1, "test": 2}
CHUNK = 512   # rows per encoder call, independent of the training batch


def states_path(base_folder, split, n_iter):
    """The JAX package's path of a split's dump (``.h5``); its numpy form
    is ``npz_path`` of it."""
    return os.path.join(base_folder, f"states_{split}_{n_iter}.h5")


def npz_path(h5_path):
    return os.path.splitext(h5_path)[0] + ".npz"


def _h5py():
    """h5py, or None where it does not import (the H100 machine)."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def _schema(cfg, n_attrs):
    """(maxshape, dtype) of each array, as the JAX package writes them."""
    return {"src": ((None, cfg.max_seq_len), np.int64),
            "z": ((None, cfg.model.z_dim), np.float16),
            "mu": ((None, cfg.model.z_dim), np.float16),
            "logvar": ((None, cfg.model.z_dim), np.float16),
            "label": ((None, n_attrs), np.int64),
            "split": ((None, 1), np.int64)}


def _write_states(path, cfg, n_attrs, rows):
    """rows: arrays keyed by H5_SETS -> the ``.npz`` beside ``path``, and
    the ``.h5`` at ``path`` where h5py imports. Returns the paths
    written."""
    schema = _schema(cfg, n_attrs)
    arrays = {k: np.asarray(rows[k]).astype(schema[k][1]) for k in H5_SETS}
    written = []
    h5py = _h5py()
    if h5py is not None:
        if os.path.isfile(path):
            os.remove(path)
        with h5py.File(path, "w") as f:
            for name, (maxshape, _) in schema.items():
                f.create_dataset(name, data=arrays[name], maxshape=maxshape,
                                 compression="gzip", compression_opts=9)
        written.append(path)
    npz = npz_path(path)
    tmp = npz + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, npz)
    written.append(npz)
    return written


def readable(path):
    """Whether ``read_states(path)`` finds a dump it can read."""
    return os.path.exists(npz_path(path)) or (
        os.path.exists(path) and _h5py() is not None)


def read_states(path):
    """{name: array} of the dump at ``path`` (the ``.h5``) or beside it
    (the ``.npz``). Raises FileNotFoundError where neither can be read."""
    h5py = _h5py()
    if h5py is not None and os.path.exists(path):
        with h5py.File(path, "r") as f:
            return {k: f[k][:] for k in H5_SETS}
    npz = npz_path(path)
    if os.path.exists(npz):
        with np.load(npz) as data:
            return {k: data[k] for k in H5_SETS}
    raise FileNotFoundError(
        f"no readable states dump at {path} (needs h5py) or {npz}; write "
        f"it with python -m controlled_peptide_generation_tpu_torch."
        f"static_eval --long")


def _present_factors(cfg, dataset):
    """Keep only the upsample factors whose columns exist in this corpus
    and match a row."""
    out = {}
    for colspec, f in dict(cfg.amp_sample_prob_factors).items():
        col = colspec.split("=")[0].lstrip("^")
        if col in dataset.columns and dataset.get_mask(colspec).any():
            out[colspec] = f
    return out


def _draw_rows(iterator, max_examples):
    """The first ``max_examples`` row indices of a batch iterator."""
    parts, count = [], 0
    for rows in iterator:
        parts.append(rows[:max_examples - count])
        count += len(parts[-1])
        if count >= max_examples:
            break
    return np.concatenate(parts)


@torch.no_grad()
def extract_from_dataset(model, params, vocab, cfg, dataset, base_folder,
                         n_iter_num, max_examples=10000):
    """Encode each split and dump its states. Returns ({split: path of
    the .h5 name}, {split: seconds}).

    The rows are those of the JAX package's ``extract_from_dataset`` (the
    same weighted iterators and seeds at cfg.vae.batch_size); they are
    encoded in chunks of CHUNK rows through ``model.encode(train=False)``
    (mu and logvar do not depend on c, so the classifier the JAX package
    calls is not needed; the GRU encoder's scans run B4 on the card), and
    each tensor is copied to the host once per split."""
    if list(dataset.vocab.itos) != list(vocab.itos):
        raise ValueError("the dataloader's vocab must match the model's")
    factors = _present_factors(cfg, dataset)
    spec = {s: {"subset": [f"split={s}"], "weighted_random_sample": True,
                "sample_prob_factors": factors}
            for s in ("train", "val", "test")}
    iterators, _ = dataset.get_subset_iterators(spec, cfg.vae.batch_size)
    dev = next(iter(checkpoints.flatten(params).values())).device
    attr_names = [a for a, _ in dataset.attributes]
    paths, seconds = {}, {}
    for split, iterator in iterators.items():
        t0 = time.perf_counter()
        batch = dataset._make_batch(_draw_rows(iterator, max_examples))
        text = torch.from_numpy(batch.text).to(dev)
        mus, logvars = [], []
        for s in range(0, text.shape[0], CHUNK):
            mu, logvar = model.encode(params, text[s:s + CHUNK], train=False)
            mus.append(mu)
            logvars.append(logvar)
        mu = torch.cat(mus).float().cpu().numpy()
        logvar = torch.cat(logvars).float().cpu().numpy()
        n = mu.shape[0]
        rows = {"src": batch.text, "mu": mu, "logvar": logvar, "z": mu,
                "label": np.stack([getattr(batch, a) for a in attr_names],
                                  axis=1),
                "split": np.full((n, 1), SPLIT_ENCODING[split], np.int64)}
        path = states_path(base_folder, split, n_iter_num)
        written = _write_states(path, cfg, len(attr_names), rows)
        paths[split] = path
        seconds[split] = time.perf_counter() - t0
        LOG.info("Wrote %d states of split %s to %s in %.3f s", n, split,
                 ", ".join(written), seconds[split])
    return paths, seconds


# ---------------------------------------------------------------------------
# exact MIPS index
# ---------------------------------------------------------------------------

def mips_topk(queries, index_z, k=10):
    """Exact inner-product top-k: queries [Q, D] x index [N, D] -> one
    product and a top-k. Returns (scores [Q, k], indices [Q, k])."""
    return torch.topk(queries @ index_z.T, k, dim=1)


def index_path(base_folder, n_iter):
    """The persisted index of iteration n_iter: an npz of the fp32 z
    matrix with schema metadata (the JAX package's format)."""
    return os.path.join(base_folder, f"index_{n_iter}.npz")


class LatentIndex:
    """Exact inner-product index over dumped z states, on ``device``."""

    _SCHEMA = 1

    def __init__(self, z, device="cpu"):
        self.z = torch.as_tensor(np.asarray(z, np.float32), device=device)

    @classmethod
    def from_states(cls, path, device="cpu"):
        return cls(read_states(path)["z"], device)

    def save(self, path):
        """Write the index so a later process loads it without the dump."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(
                fh, z=self.z.cpu().numpy(), schema=np.asarray(self._SCHEMA),
                metric=np.asarray("inner_product"))
        os.replace(tmp, path)
        LOG.info("wrote latent index (%d x %d) to %s", self.z.shape[0],
                 self.z.shape[1], path)
        return path

    @classmethod
    def load(cls, path, device="cpu"):
        with np.load(path) as data:
            if int(data["schema"]) != cls._SCHEMA:
                raise ValueError(
                    f"{path}: unsupported index schema "
                    f"{int(data['schema'])} (expected {cls._SCHEMA})")
            return cls(data["z"], device)

    def search(self, queries, k=10):
        """(scores [Q, k], indices [Q, k]) as numpy arrays."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.z.device)
        scores, idx = mips_topk(q, self.z, k)
        return scores.cpu().numpy(), idx.cpu().numpy()
