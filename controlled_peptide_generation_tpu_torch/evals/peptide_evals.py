"""Physicochemical columns of generated peptides.

The part of the JAX package's ``evals/peptide_evals.py`` the CLaSS round
needs: the Eisenberg hydrophobicity scale, the hydrophobic moment (100
degree helix angle) and the net charge (E/D = -1, K/R = +1), vectorized
over a token matrix (``modlamp_from_tokens``, the fused loop's) or per
peptide string (``compute_modlamp``, the serial loop's).
"""

import numpy as np

EISENBERG = {'A': 0.25, 'R': -1.80, 'N': -0.64, 'D': -0.72, 'C': 0.04,
             'Q': -0.69, 'E': -0.62, 'G': 0.16, 'H': -0.40, 'I': 0.73,
             'L': 0.53, 'K': -1.10, 'M': 0.26, 'F': 0.61, 'P': -0.07,
             'S': -0.26, 'T': -0.18, 'W': 0.37, 'Y': 0.02, 'V': 0.54}

AA_CHARGE = {'E': -1, 'D': -1, 'K': 1, 'R': 1}


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
