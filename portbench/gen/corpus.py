"""The synthetic peptide corpus the training cells read: a frozen copy of
the port's ``data/synthetic.py`` generator (itself the JAX package's), so
later changes to the port do not change the benchmark's data.

It writes csv files with the schema of the CLaSS reference's curation
(``text`` plus one attribute column per labelled file). With
``structured=True`` sequences are assembled from per-class motif banks
with point mutations, so a reference-scale corpus (about 100k rows) has
the regularity of real peptide corpora.
"""

import json
import os
import random

AA = list("ACDEFGHIKLMNPQRSTVWY")
# crude composition biases: AMP-positive -> cationic/hydrophobic-rich,
# tox-positive -> cysteine/aromatic-rich
_POS_BIAS = {"K": 4.0, "R": 4.0, "L": 3.0, "I": 2.0, "W": 2.0}
_TOX_BIAS = {"C": 4.0, "W": 3.0, "F": 2.0, "Y": 2.0}


def _weights(bias):
    return [bias.get(a, 1.0) for a in AA]


def _seq(rng, min_len, max_len, bias=None):
    n = rng.randint(min_len, max_len)
    w = _weights(bias or {})
    return " ".join(rng.choices(AA, weights=w, k=n))


def _motif_bank(rng, bias, n_motifs=48, lo=3, hi=7):
    """A family's inventory of short conserved fragments."""
    w = _weights(bias or {})
    return ["".join(rng.choices(AA, weights=w, k=rng.randint(lo, hi)))
            for _ in range(n_motifs)]


def _structured_seq(rng, bank, bg_bank, min_len, max_len, p_mut=0.10,
                    p_bg=0.25):
    """Concatenate 1-4 motifs (family bank, with background mixing), apply
    point mutations, clip to [min_len, max_len]."""
    chars = []
    while len(chars) < max_len:
        src = bg_bank if rng.random() < p_bg else bank
        chars.extend(rng.choice(src))
        if len(chars) >= min_len and rng.random() < 0.35:
            break
    chars = chars[:rng.randint(min_len, max_len)]
    chars = [rng.choice(AA) if rng.random() < p_mut else c for c in chars]
    return " ".join(chars)


def generate(data_path, n_unlab=600, n_amp=200, n_tox=200, seed=7734,
             min_len=5, max_len=23, structured=False):
    """Write unlab.csv / amp_lab.csv / tox_lab.csv under data_path."""
    rng = random.Random(seed)
    os.makedirs(data_path, exist_ok=True)
    seen = set()

    if structured:
        # one motif inventory per family; the "neg" families get their own
        # banks (distinct from background) so classifiers must separate
        # structure, not just composition
        banks = {
            "bg": _motif_bank(rng, None),
            "amp_pos": _motif_bank(rng, _POS_BIAS),
            "amp_neg": _motif_bank(rng, None),
            "tox_pos": _motif_bank(rng, _TOX_BIAS),
            "tox_neg": _motif_bank(rng, None),
        }

    def fresh(bias=None, family=None):
        for _ in range(1000):
            if structured:
                s = _structured_seq(rng, banks[family or "bg"], banks["bg"],
                                    min_len, max_len)
            else:
                s = _seq(rng, min_len, max_len, bias)
            if s not in seen:
                seen.add(s)
                return s
        raise RuntimeError("could not generate a fresh sequence")

    with open(os.path.join(data_path, "unlab.csv"), "w") as f:
        f.write("text\n")
        for _ in range(n_unlab):
            f.write(fresh() + "\n")

    with open(os.path.join(data_path, "amp_lab.csv"), "w") as f:
        f.write("text,amp\n")
        for i in range(n_amp):
            if i % 2 == 0:
                f.write(f"{fresh(_POS_BIAS, 'amp_pos')},amp_posc\n")
            else:
                f.write(f"{fresh(None, 'amp_neg')},amp_negc\n")

    with open(os.path.join(data_path, "tox_lab.csv"), "w") as f:
        f.write("text,tox\n")
        for i in range(n_tox):
            if i % 2 == 0:
                f.write(f"{fresh(_TOX_BIAS, 'tox_pos')},tox_posc\n")
            else:
                f.write(f"{fresh(None, 'tox_neg')},tox_negc\n")

    meta = dict(n_unlab=n_unlab, n_amp=n_amp, n_tox=n_tox, seed=seed,
                min_len=min_len, max_len=max_len, structured=structured)
    with open(os.path.join(data_path, "_gen_meta.json"), "w") as f:
        json.dump(meta, f)
    return data_path
