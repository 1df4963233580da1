"""Batched global sequence alignment (Needleman-Wunsch-Gotoh) on the device.

The score of the similarity eval (``peptide_evals.PeptideEvaluator``):
global alignment with the BLOSUM62 substitution matrix and affine gaps
(open -10, extend -1; a gap of length L costs open + (L-1)*extend; end
gaps penalized). Only the optimal score is computed.

All pairs advance one DP row at a time. In a row, M and Ix depend only on
the row above; Iy along the row is a max-plus scan,
``Iy_j = (j-1)*ge + go + max_{k<j}(M_k - k*ge)``, so one row is a few
tensor operations and one ``torch.cummax``, whatever the number of pairs.
The boundary conditions are those of the JAX package's scan: column 0
holds neither a match nor a horizontal gap (both NEG), so a switch from a
vertical to a horizontal gap costs a new open. In float32 the cells that
derive from NEG depend on the order of the sums; the optimal scores are
sums of integers, and exact.
"""

import numpy as np
import torch

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
AA_TO_IX = {a: i for i, a in enumerate(AA_ORDER)}

# standard BLOSUM62 (half-bit scores), rows/cols in AA_ORDER
BLOSUM62 = np.array([
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4],
], np.float32)

NEG = -1e9


def encode_seqs(seqs, max_len):
    """Residue strings -> (int codes [N, max_len], lengths [N])."""
    codes = np.zeros((len(seqs), max_len), np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        s = s[:max_len]
        lens[i] = len(s)
        for j, a in enumerate(s):
            codes[i, j] = AA_TO_IX[a]
    return codes, lens


def align_scores(a_codes, b_codes, a_lens, b_lens, gap_open=-10.0,
                 gap_extend=-1.0, device=None):
    """Batched optimal global alignment scores on ``device`` (default: that
    of ``a_codes``, the CPU for numpy arrays).

    a_codes/b_codes: [P, L] int residue codes; a_lens/b_lens: [P].
    Returns [P] float32 scores, a tensor on that device."""
    device = torch.as_tensor(a_codes, device=device).device
    a, b, la, lb = (torch.as_tensor(x, device=device).long()
                    for x in (a_codes, b_codes, a_lens, b_lens))
    P, L = a.shape
    S = torch.as_tensor(BLOSUM62, device=device)
    sub = S[a[:, :, None], b[:, None, :]]              # [P, L, L]
    j = torch.arange(L + 1, device=device, dtype=torch.float32)
    neg = torch.full((P, 1), NEG, device=device)
    # row 0: the empty prefix of a against b[:j]
    M = torch.where(j == 0, 0.0, NEG).expand(P, L + 1)
    Ix = torch.full((P, L + 1), NEG, device=device)
    Iy = torch.where(j == 0, NEG, gap_open + (j - 1) * gap_extend).expand(
        P, L + 1)
    lb_col = lb[:, None]
    empty_b = torch.where(lb == 0, 0.0, Iy.gather(1, lb_col)[:, 0])
    result = torch.where(la == 0, empty_b, NEG)
    k_ge = j * gap_extend                               # k * ge
    iy_off = (j[1:] - 1) * gap_extend + gap_open        # (j-1)*ge + go
    for i in range(1, L + 1):
        diag = torch.maximum(torch.maximum(M, Ix), Iy)[:, :-1]
        ix = torch.maximum(M[:, 1:] + gap_open, Ix[:, 1:] + gap_extend)
        M = torch.cat([neg, diag + sub[:, i - 1]], dim=1)
        Ix = torch.cat([torch.full((P, 1), gap_open + (i - 1) * gap_extend,
                                   device=device), ix], dim=1)
        # exclusive running max over k < j of M_k - k*ge (M_0 is NEG)
        run = torch.cummax(M - k_ge, dim=1).values[:, :-1]
        Iy = torch.cat([neg, iy_off + run], dim=1)
        v = torch.maximum(torch.maximum(M, Ix), Iy).gather(1, lb_col)[:, 0]
        result = torch.where(la == i, v, result)
    return result
