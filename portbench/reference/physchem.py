"""The served rows' text and physicochemical columns, per peptide string:
detokenisation (residues joined by spaces, special tokens dropped), the
mean Eisenberg hydrophobicity H, the hydrophobic moment uH at a 100
degree helix angle, and the net charge (K, R +1; D, E -1), as modlAMP
defines them."""

import math

EISENBERG = {"A": 0.25, "R": -1.80, "N": -0.64, "D": -0.72, "C": 0.04,
             "Q": -0.69, "E": -0.62, "G": 0.16, "H": -0.40, "I": 0.73,
             "L": 0.53, "K": -1.10, "M": 0.26, "F": 0.61, "P": -0.07,
             "S": -0.26, "T": -0.18, "W": 0.37, "Y": 0.02, "V": 0.54}
CHARGE = {"E": -1, "D": -1, "K": 1, "R": 1}


def detokenize(tokens, itos):
    """One token row -> its peptide: the residues (ids above 3) joined by
    spaces."""
    return " ".join(itos[int(t)] for t in tokens if int(t) > 3)


def physchem(peptide):
    """(H, uH, charge) of a space-separated peptide; 0.0 each when empty."""
    res = peptide.split()
    if not res:
        return 0.0, 0.0, 0.0
    h = [EISENBERG.get(a, 0.0) for a in res]
    cos_s = sum(v * math.cos(math.radians(100.0 * i)) for i, v in enumerate(h))
    sin_s = sum(v * math.sin(math.radians(100.0 * i)) for i, v in enumerate(h))
    return (sum(h) / len(h), math.hypot(cos_s, sin_s) / len(h),
            float(sum(CHARGE.get(a, 0) for a in res)))
