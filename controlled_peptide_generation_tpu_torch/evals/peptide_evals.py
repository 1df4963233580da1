"""Physicochemical peptide evaluation.

The JAX package's ``evals/peptide_evals.py``: the Eisenberg
hydrophobicity scale, the hydrophobic moment (100 degree helix angle) and
the net charge (E/D = -1, K/R = +1), vectorized over a token matrix
(``modlamp_from_tokens``, the fused loop's) or per peptide string
(``compute_modlamp``, the serial loop's); and ``PeptideEvaluator``, the
corpus-level suite: the averages of those, the amino-acid class fractions
and composition, and the BLOSUM62 alignment similarity between random
sample pairs, scored by the batched aligner (``evals/alignment.py``) on
the device.
"""

import collections
import random
from math import log

import numpy as np

from ..utils import runtime
from . import alignment

EISENBERG = {'A': 0.25, 'R': -1.80, 'N': -0.64, 'D': -0.72, 'C': 0.04,
             'Q': -0.69, 'E': -0.62, 'G': 0.16, 'H': -0.40, 'I': 0.73,
             'L': 0.53, 'K': -1.10, 'M': 0.26, 'F': 0.61, 'P': -0.07,
             'S': -0.26, 'T': -0.18, 'W': 0.37, 'Y': 0.02, 'V': 0.54}

AA_CHARGE = {'E': -1, 'D': -1, 'K': 1, 'R': 1}

POLAR_AA = set("STNHQG")
SPECI_AA = set("PC")
APOLAR_AA = set("ALVIM")
CHARGED_AA = set("EDKR")
AROMATIC_AA = set("WYF")

SPECIAL_TOKENS = ("<unk>", "<pad>", "<start>", "<eos>")


def clean_sequence(s):
    """Space-separated tokens -> residue string; '' if any special token
    appears."""
    toks = s.split()
    if any(t in SPECIAL_TOKENS for t in toks):
        return ""
    return "".join(toks)


def assign_hydrophobicity(sequence, scale="Eisenberg"):
    if scale != "Eisenberg":
        raise KeyError(f"{scale} is not a supported scale.")
    try:
        return [EISENBERG[aa] for aa in sequence]
    except KeyError as e:
        raise KeyError(f"Amino acid not defined in scale: {e}") from e


def modlamp_from_tokens(tokens, itos):
    """H / uH / charge from a [N, T] token matrix, row for row equal to
    the per-peptide formulas on the decoded residues (specials, ids 0..3,
    are stripped as the decode does)."""
    tokens = np.asarray(tokens)
    eis = np.array([EISENBERG.get(w, 0.0) for w in itos])
    chg = np.array([float(AA_CHARGE.get(w, 0)) for w in itos])
    valid = tokens > 3
    n = valid.sum(axis=1)
    h = eis[tokens] * valid
    # residue position within the cleaned peptide (0-based)
    pos = np.cumsum(valid, axis=1) - 1
    rad = np.deg2rad(pos * 100.0)
    cos_s = (h * np.cos(rad)).sum(axis=1)
    sin_s = (h * np.sin(rad)).sum(axis=1)
    n_safe = np.maximum(n, 1)
    H = h.sum(axis=1) / n_safe
    uH = np.hypot(cos_s, sin_s) / n_safe
    charge = (chg[tokens] * valid).sum(axis=1)
    empty = n == 0
    return (np.where(empty, 0.0, H), np.where(empty, 0.0, uH),
            np.where(empty, 0.0, charge))


def calculate_moment(hvalues, angle=100):
    """uH = sqrt((sum H_i cos(i*d))^2 + (sum H_i sin(i*d))^2) / len."""
    rad = np.deg2rad(np.arange(len(hvalues)) * angle)
    hv = np.asarray(hvalues)
    return float(np.hypot(np.sum(hv * np.cos(rad)),
                          np.sum(hv * np.sin(rad))) / len(hvalues))


def calculate_charge(sequence):
    return sum(AA_CHARGE.get(aa, 0) for aa in sequence)


def compute_modlamp(df):
    """A copy of the peptide DataFrame ``df`` with H / uH / charge columns,
    computed per peptide string (spaces stripped; an empty peptide gets
    0.0 in each)."""
    H, uH, charge = [], [], []
    for pep in df["peptide"].str.replace(" ", "", regex=False):
        if len(pep) == 0:
            H.append(0.0)
            uH.append(0.0)
            charge.append(0.0)
            continue
        hv = [EISENBERG.get(aa, 0.0) for aa in pep]
        H.append(sum(hv) / len(hv))
        uH.append(calculate_moment(hv))
        charge.append(float(calculate_charge(pep)))
    df = df.copy()
    df.loc[:, "H"] = H
    df.loc[:, "uH"] = uH
    df.loc[:, "charge"] = charge
    return df


class PeptideEvaluator:
    """The corpus-level peptide suite. ``device`` is where ``similarity``
    aligns its pairs: CUDA unless the caller asks for the CPU."""

    def __init__(self, orig_filename=None, seq_len=0, device="cuda"):
        self.orig_filename = orig_filename
        self.seq_len = seq_len
        self.device = device
        self.gap_open = -10
        self.gap_extend = -1
        self.scales = {"Eisenberg": EISENBERG}
        self._supported_scales = ["Eisenberg"]
        self.aa_charge = AA_CHARGE

    # kept as a method for the reference API
    def f(self, s):
        return clean_sequence(s)

    def assign_hydrophobicity(self, sequence, scale="Eisenberg"):
        return assign_hydrophobicity(sequence, scale)

    def calculate_moment(self, array, angle=100):
        return calculate_moment(array, angle)

    def calculate_charge(self, sequence):
        return calculate_charge(sequence)

    def convert_to_fasta(self, inpfile, fastafile, seq_len):
        count = 1
        with open(inpfile) as fin, open(fastafile, "w+") as fout:
            for line in fin:
                if line[0:5] != "label":
                    s = line.rstrip("\n").split(",")[0].replace(" ", "")
                    if 0 < len(s) < seq_len:
                        fout.write(f"> {count} {len(s)}\n{s}\n")
                        count += 1

    def heuristics(self, seqs):
        """Corpus-level averages: hydrophobicity, moment, charge, size,
        AA-class fractions."""
        aa_count = 0
        av_h, av_uH = 0.0, 0.0
        n_p = n_s = n_a = n_ar = n_c = 0
        for rec in seqs:
            rec = clean_sequence(rec)
            aa_count += len(rec)
            for aa in rec:
                if aa in POLAR_AA:
                    n_p += 1
                elif aa in SPECI_AA:
                    n_s += 1
                elif aa in APOLAR_AA:
                    n_a += 1
                elif aa in CHARGED_AA:
                    n_c += 1
                elif aa in AROMATIC_AA:
                    n_ar += 1
            seq_h = assign_hydrophobicity(rec)
            if seq_h:
                av_h += sum(seq_h) / len(seq_h)
                av_uH += calculate_moment(seq_h)
        n = len(seqs)
        sizes = [len(clean_sequence(rec)) for rec in seqs]
        # a collapsed model can emit only special-token sequences: every
        # rec cleans to '' and aa_count is 0 (degenerate stats, no crash)
        aa_count = max(aa_count, 1)
        return {
            "av_h": av_h / n,
            "av_uH": av_uH / n,
            "avg_size": float(sum(sizes) / len(sizes)),
            "av_n_p": round(n_p / aa_count, 3),
            "av_n_s": round(n_s / aa_count, 3),
            "av_n_a": round(n_a / aa_count, 3),
            "av_n_c": round(n_c / aa_count, 3),
            "av_n_ar": round(n_ar / aa_count, 3),
        }

    def aa_composition(self, seqs):
        all_aas = collections.defaultdict(int)
        aa_count = 0
        for rec in seqs:
            rec = clean_sequence(rec)
            aa_count += len(rec)
            for aa in rec:
                all_aas[aa] += 1
        if aa_count < 1:
            return {aa: 1 for aa in EISENBERG}
        return {aa: round(c / aa_count, 3) for aa, c in all_aas.items()}

    def similarity_pairs(self, seqs_lst1, seqs_lst2, matrix_size=100):
        """The residue-string pairs ``similarity`` scores: matrix_size
        random samples of each list (Python's ``random.sample``, so the
        same ``random.seed`` draws the same pairs as the JAX package),
        every pair of them with both longer than 1 residue and unequal."""
        s1 = [clean_sequence(r)
              for r in random.sample(list(seqs_lst1),
                                     min(matrix_size, len(seqs_lst1)))]
        s2 = [clean_sequence(r)
              for r in random.sample(list(seqs_lst2),
                                     min(matrix_size, len(seqs_lst2)))]
        return [(a, b) for a in s1 for b in s2
                if len(a) > 1 and len(b) > 1 and a != b]

    def similarity(self, seqs_lst1, seqs_lst2, matrix_size=100):
        """Mean BLOSUM62 global-alignment score between matrix_size^2
        random pairs, each normalized by log(len): all pairs in one batched
        alignment on ``self.device``."""
        device = runtime.setup(self.device)
        pairs = self.similarity_pairs(seqs_lst1, seqs_lst2, matrix_size)
        if not pairs:
            return {"sim": []}, 0.0
        max_len = max(max(len(a), len(b)) for a, b in pairs)
        a_codes, a_lens = alignment.encode_seqs([a for a, _ in pairs],
                                                max_len)
        b_codes, b_lens = alignment.encode_seqs([b for _, b in pairs],
                                                max_len)
        scores = alignment.align_scores(
            a_codes, b_codes, a_lens, b_lens, gap_open=float(self.gap_open),
            gap_extend=float(self.gap_extend), device=device).cpu().numpy()
        sim_lst = [float(s / log(len(a)))
                   for s, (a, _) in zip(scores, pairs)]
        av_sim = sum(sim_lst) / len(sim_lst) if sim_lst else 0.0
        return {"sim": sim_lst}, av_sim
