"""Host-side data pipeline: fixed-shape int32 token batches.

The port's own copy of the JAX package's ``data/loader.py``, written with
numpy and the standard library only (no pandas): merge N csv files keyed
by sequence text, a seeded 80/10/10 split, the subset mini-language,
per-row sample weights with upsample factors, infinite weighted-
multinomial iterators, and a vocabulary with pinned special indices. The
same files, seeds and specs give the same splits, vocabulary, token
matrix and batches as the JAX package.

Every batch is a ``(B, max_seq_len)`` int32 array ([START] + at most
max_seq_len - 2 tokens + [EOS] + PAD); the whole corpus is tokenized once
at load time by the native tokenizer (``native/``, compiled from its C
source at its first use), so drawing a batch is one fancy-index gather.
"""

import csv
import io
import logging
import os
import random
from types import SimpleNamespace

import numpy as np

from .. import native
from .vocab import Vocab

LOG = logging.getLogger(__name__)

# csv files the amp spec lists but the released curation never emits:
# their absence is tolerated with a warning
OPTIONAL_CSV_FILES = frozenset({
    "sol_lab.csv", "anticancer.csv", "antihypertensive.csv",
    "cell-cell.csv",
})


class _WeightedRandomIterator:
    """Infinite batches drawn i.i.d. from a multinomial with replacement,
    `block` batches per numpy call."""

    def __init__(self, indices, weights, batch_size, seed, block=128):
        self.indices = np.asarray(indices)
        p = np.asarray(weights, dtype=np.float64)
        if p.size == 0 or p.sum() <= 0.0:
            raise ValueError(
                "empty or zero-weight subset: the iterator's subset "
                f"specifiers matched {p.size} rows (total weight "
                f"{p.sum() if p.size else 0.0}) — check the subset "
                "mini-language specs and corpus contents")
        self.p = p / p.sum()
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.block = block

    def __iter__(self):
        while True:
            draws = self.rng.choice(
                self.indices, size=(self.block, self.batch_size),
                replace=True, p=self.p)
            yield from draws


class _ShuffledIterator:
    """Epoch-shuffled batches, optionally repeating."""

    def __init__(self, indices, batch_size, seed, repeat):
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.repeat = repeat

    def __iter__(self):
        while True:
            order = self.rng.permutation(len(self.indices))
            for s in range(0, len(order), self.batch_size):
                yield self.indices[order[s:s + self.batch_size]]
            if not self.repeat:
                return

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)


class AttributeDataLoader:
    """Merged multi-csv corpus with named subset iterators.

    ``next_batch(name)`` returns a SimpleNamespace with ``.text``
    (np.int32 [B, max_seq_len]) and one np.int64 [B] array per attribute.
    The corpus is a list of row dicts (``rows``, csv column -> string;
    a column a row's files did not have is absent) and a ``split`` array.
    """

    def __init__(self, mbsize=32, max_seq_len=25, data_path=None,
                 csv_files=(), attributes=(), iteratorspecs=None,
                 split_seed=1238, fixed_vocab_path="", iterator_seed=7,
                 **_unused):
        self.mbsize = mbsize
        self.max_seq_len = max_seq_len
        self.attributes = list(attributes)
        self.attr_maps = dict(self.attributes)
        self._iterator_seed = iterator_seed
        self._warned_factors = set()

        self.rows = self._read_csvs(data_path, csv_files, max_seq_len)
        self.columns = {k for row in self.rows for k in row}
        self.split = self._compute_splits([0.8, 0.1, 0.1], split_seed)

        if fixed_vocab_path:
            self.vocab = Vocab.load(fixed_vocab_path)
        else:
            self.vocab = Vocab.build(
                row["text"].split() for row, s in zip(self.rows, self.split)
                if s == "train")
        self.n_vocab = len(self.vocab)

        # the whole corpus tokenized once by the native tokenizer (built
        # at its first use)
        self.tokens = native.tokenize_corpus(
            [row["text"] for row in self.rows], self.vocab.stoi, max_seq_len)
        self.labels = {}
        for name, mapping in self.attributes:
            vals = np.empty(len(self.rows), dtype=np.int64)
            for i, row in enumerate(self.rows):
                raw = row.get(name, "na")
                if raw not in mapping:
                    raise KeyError(
                        f"Key {raw} not in mappingdict for attribute {name}")
                vals[i] = mapping[raw]
            self.labels[name] = vals

        self.iterators = {}
        self.subset_sizes = {}
        if iteratorspecs:
            self.iterators, _ = self.get_subset_iterators(iteratorspecs,
                                                          mbsize)
        self._iters = {k: iter(v) for k, v in self.iterators.items()}

    # ---- corpus construction -----------------------------------------------

    @staticmethod
    def _read_csvs(path, csv_files, max_seq_len):
        data = {}
        found = 0
        for csv_file in csv_files:
            fn = os.path.join(path, csv_file)
            if not os.path.exists(fn) and csv_file in OPTIONAL_CSV_FILES:
                LOG.warning("optional corpus file %s not found; its "
                            "attribute column will be all-NA", fn)
                continue
            with io.open(fn, encoding="utf8") as f:
                for entry in csv.DictReader(f):
                    data.setdefault(entry["text"].strip(), {}).update(entry)
            found += 1
        if not found:
            raise FileNotFoundError(
                f"no corpus csv files found under {path} (looked for "
                f"{list(csv_files)})")
        rows = [data[k] for k in sorted(data)]
        return [r for r in rows if len(r["text"].strip().split())
                <= max_seq_len]

    def _compute_splits(self, ratios, seed):
        # seeded shuffle of the (alphabetical) row order, then contiguous
        # slices
        if len(ratios) != 3 or sum(ratios) != 1.0:
            raise ValueError(f"split ratios must be 3 summing to 1: {ratios}")
        n = len(self.rows)
        rix = list(range(n))
        random.Random(seed).shuffle(rix)
        a, b = int(ratios[0] * n), int(ratios[1] * n)
        split = np.empty(n, dtype=object)
        split[rix[:a]] = "train"
        split[rix[a:a + b]] = "val"
        split[rix[a + b:]] = "test"
        return split

    def _column(self, key):
        """The column as an object array, None where a row lacks it."""
        if key == "split":
            return self.split
        return np.array([row.get(key) for row in self.rows], dtype=object)

    # ---- subset mini-language --------------------------------------------------

    def get_mask(self, colspecifier):
        """'col' (present), '^col' (absent), 'col=v1,v2' (one of the
        values), '^col=v1,v2' (none of them) -> bool [N]."""
        negate = colspecifier.startswith("^")
        key = colspecifier[1:] if negate else colspecifier
        allowed = None
        if "=" in key:
            key, allowed = key.split("=")
        if key not in self.columns and key != "split":
            return np.full(len(self.rows), negate)
        col = self._column(key)
        if allowed is not None:
            values = set(allowed.split(","))
            mask = np.array([v in values for v in col], dtype=bool)
            return ~mask if negate else mask
        present = np.array([v is not None for v in col], dtype=bool)
        return ~present if negate else present

    def get_subset_indices(self, *colspecifiers):
        mask = np.ones(len(self.rows), dtype=bool)
        for cs in colspecifiers:
            mask &= self.get_mask(cs)
        return np.flatnonzero(mask)

    def _sample_weights(self, indices, sample_prob_factors=None):
        """Upsample-factor weights: the largest matching factor, 1 by
        default."""
        w = np.ones(len(self.rows), dtype=np.float64)
        for colspecifier, factor in (sample_prob_factors or {}).items():
            mask = self.get_mask(colspecifier)
            if not mask.any():
                if colspecifier not in self._warned_factors:
                    self._warned_factors.add(colspecifier)
                    LOG.warning("sample factor %r matches no rows; "
                                "ignored", colspecifier)
                continue
            w[mask & (w < factor)] = factor
        return w[indices]

    def get_subset_iterators(self, iteratorspecs, mbsize):
        iterators, subsets = {}, {}
        for i, (name, spec) in enumerate(iteratorspecs.items()):
            spec = dict(spec)
            idx = self.get_subset_indices(*spec.pop("subset"))
            seed = self._iterator_seed + 1000 * i
            if spec.pop("weighted_random_sample", False):
                w = self._sample_weights(
                    idx, spec.pop("sample_prob_factors", None))
                iterators[name] = _WeightedRandomIterator(idx, w, mbsize,
                                                          seed)
            else:
                iterators[name] = _ShuffledIterator(
                    idx, mbsize, seed, spec.pop("repeat", True))
            subsets[name] = idx
            self.subset_sizes[name] = len(idx)
        return iterators, subsets

    # ---- batches -----------------------------------------------------------

    def _make_batch(self, row_indices):
        batch = SimpleNamespace(text=self.tokens[row_indices])
        for name, _ in self.attributes:
            setattr(batch, name, self.labels[name][row_indices])
        return batch

    def next_batch(self, iterator_name):
        return self._make_batch(next(self._iters[iterator_name]))

    def print_stats(self, out=print):
        out(f"Vocab size: {self.n_vocab}")
        out("Vocab (first 50): " + " / ".join(self.vocab.itos[:50]))
        for name, size in self.subset_sizes.items():
            out(f"iterator {name:10s}: subset data size: {size:7d}")

    # ---- index -> text ---------------------------------------------------------

    def idx2sentence(self, idxs, print_special_tokens=True):
        return self.vocab.to_sentence(idxs, print_special_tokens)

    def idx2sentences(self, idxs, print_special_tokens=True):
        """A [N, T] token matrix -> N sentences."""
        return self.vocab.to_sentences_batch(idxs, print_special_tokens)
