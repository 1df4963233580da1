"""Synthetic peptide corpus generator for smoke tests and benchmarks (the
port's own copy of the JAX package's ``data/synthetic.py``: the same
generator, so one seed writes the same corpus from either package).

Writes csv files with the exact schema produced by the reference's offline
curation step (data_processing/create_datasets.py:566-617: columns
``text`` plus one attribute column per labeled file), so the loader and the
whole pipeline run self-contained without the proprietary corpora.

Two generation modes:

* default (``structured=False``): random amino-acid strings whose
  composition is biased by the attribute label — enough signal for latent
  classifiers, cheap to generate; used by the test suite.
* ``structured=True``: sequences are assembled from per-class MOTIF BANKS
  (short conserved fragments with point mutations), mimicking the
  regularity of real peptide corpora (AMPs share cationic/amphipathic
  motifs). The motif inventory is learnable without memorizing individual
  rows, so a reference-scale (~100k row) corpus trains a NON-degenerate
  autoencoder: heldout recon tracks train recon and free-running decodes
  are diverse. This is the corpus the flagship campaigns use.

``ensure`` records the generation arguments in ``_gen_meta.json`` and
regenerates when a caller asks for a different corpus than the one on
disk, so scaling flags take effect without manual cleanup.
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


def ensure(data_path, **kw):
    """Generate the corpus if absent OR if the on-disk one was generated
    with different arguments (``_gen_meta.json`` mismatch)."""
    marker = os.path.join(data_path, "unlab.csv")
    meta_path = os.path.join(data_path, "_gen_meta.json")
    if os.path.exists(marker):
        want = dict(n_unlab=600, n_amp=200, n_tox=200, seed=7734,
                    min_len=5, max_len=23, structured=False)
        want.update(kw)
        have = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                have = json.load(f)
        if have == want:
            return data_path
    generate(data_path, **kw)
    return data_path
