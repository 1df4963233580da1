"""Amino-acid-level vocabulary with pinned special token indices.

The port's copy of what it needs of the JAX package's ``data/vocab.py``
(the port imports nothing of that package). The four reserved indices are
load-bearing: the recon loss ignores PAD, generation masks with PAD/EOS and
beam search blocks START.
File format on disk is 'word ix' text lines.
"""

import codecs
import os
from collections import Counter

import numpy as np

UNK_IDX = 0
PAD_IDX = 1
START_IDX = 2
EOS_IDX = 3

UNK_TOK = "<unk>"
PAD_TOK = "<pad>"
START_TOK = "<start>"
EOS_TOK = "<eos>"
SPECIALS = [UNK_TOK, PAD_TOK, START_TOK, EOS_TOK]


class Vocab:
    """itos/stoi with specials pinned at indices 0..3."""

    def __init__(self, itos):
        self.itos = list(itos)
        self.stoi = {w: i for i, w in enumerate(self.itos)}
        for ix, tok in zip([UNK_IDX, PAD_IDX, START_IDX, EOS_IDX], SPECIALS):
            if self.itos[ix] != tok:
                raise ValueError(
                    f"special token {tok} not at index {ix}: {self.itos[:4]}")
        self.special_ix = {UNK_IDX, PAD_IDX, START_IDX, EOS_IDX}

    def __len__(self):
        return len(self.itos)

    def size(self):
        return len(self.itos)

    @classmethod
    def build(cls, token_iter):
        """Frequency-sorted vocab (ties alphabetical), specials first."""
        counts = Counter()
        for toks in token_iter:
            counts.update(toks)
        words = sorted(counts, key=lambda w: (-counts[w], w))
        return cls(SPECIALS + [w for w in words if w not in SPECIALS])

    @classmethod
    def load(cls, path):
        pairs = []
        with codecs.open(path, "r", "utf-8") as f:
            for line in f:
                lsp = line.split()
                if not lsp:
                    continue
                word = " ".join(lsp[:-1])
                pairs.append((int(lsp[-1]), word))
        pairs.sort()
        if [ix for ix, _ in pairs] != list(range(len(pairs))):
            raise ValueError(
                f"{path}: vocab file indices must be a 0..N-1 permutation")
        return cls([w for _, w in pairs])

    def save(self, path):
        """Write 'word ix' lines."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for word, ix in self.stoi.items():
                f.write(f"{word} {ix}\n")

    def to_ix(self, seq, fix_length=None):
        """Tokenized sequence -> [START] + tokens + [EOS] (+ PAD to width).
        ``fix_length`` is the total output width; tokens are cut to
        fix_length - 2."""
        if isinstance(seq, str):
            seq = seq.split()
        toks = [t for t in seq if t not in (START_TOK, EOS_TOK)]
        if fix_length is not None:
            toks = toks[:fix_length - 2]
        ixs = ([START_IDX] + [self.stoi.get(t, UNK_IDX) for t in toks]
               + [EOS_IDX])
        if fix_length is not None:
            ixs = ixs + [PAD_IDX] * (fix_length - len(ixs))
        return ixs

    def to_words(self, ixs, print_special_tokens=True):
        ixs = [int(i) for i in ixs]
        if not print_special_tokens:
            ixs = [i for i in ixs if i not in self.special_ix]
        return [self.itos[i] for i in ixs]

    def to_sentence(self, ixs, print_special_tokens=True):
        return " ".join(self.to_words(ixs, print_special_tokens))

    def to_sentences_batch(self, tokens, print_special_tokens=True):
        """2-D token matrix -> list of sentences (one numpy gather for the
        id->word mapping)."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 2:
            raise ValueError(f"expected a 2-D token matrix: {tokens.shape}")
        lut = np.array(self.itos, dtype=object)
        words = lut[tokens]
        if print_special_tokens:
            return [" ".join(row) for row in words]
        keep = tokens > EOS_IDX  # specials are pinned at 0..3
        return [" ".join(row[k]) for row, k in zip(words, keep)]
