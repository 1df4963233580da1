"""The port's peptide evaluation suite against the JAX package's on the CPU.

The batched aligner exactly (its scores are sums of integers), the
sequence cleaning, ``PeptideEvaluator``'s heuristics, composition and fasta
file equal, and its similarity under one ``random.seed`` equal within rtol
1e-6 (the same pairs, the same scores)."""

import random

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from controlled_peptide_generation_tpu.evals import alignment as j_al
from controlled_peptide_generation_tpu.evals import peptide_evals as j_pe

from controlled_peptide_generation_tpu_torch.evals import alignment as t_al
from controlled_peptide_generation_tpu_torch.evals import peptide_evals as t_pe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch and BLAS on one CPU thread: the small shapes here are faster
    so, and a worker of a parallel test run does not fight the others for
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _random_peptides(rng, n, lo, hi):
    return ["".join(rng.choice(list(t_al.AA_ORDER), int(rng.integers(lo,
                                                                     hi + 1))))
            for _ in range(n)]


def test_tables_match_jax():
    np.testing.assert_array_equal(t_al.BLOSUM62, j_al.BLOSUM62)
    assert t_al.AA_ORDER == j_al.AA_ORDER and t_al.NEG == j_al.NEG
    assert t_pe.EISENBERG == j_pe.EISENBERG
    assert t_pe.SPECIAL_TOKENS == j_pe.SPECIAL_TOKENS


def test_align_scores_match_jax_exactly():
    """2,000 random pairs of lengths 0-25, the empty and length-1 cases
    among them: every score equal to the JAX scan's."""
    rng = np.random.default_rng(12)
    P, L = 2000, 25
    a = _random_peptides(rng, P, 0, L)
    b = _random_peptides(rng, P, 0, L)
    a[:6] = ["", "", "A", "W", "W" * 25, "ACDE"]
    b[:6] = ["", "K", "", "W", "P", ""]
    ac, al = t_al.encode_seqs(a, L)
    bc, bl = t_al.encode_seqs(b, L)
    jc, jl = j_al.encode_seqs(a, L)
    np.testing.assert_array_equal(ac, jc)
    np.testing.assert_array_equal(al, jl)
    want = np.asarray(j_al.align_scores(jc, j_al.encode_seqs(b, L)[0], jl,
                                        bl))
    got = t_al.align_scores(ac, bc, al, bl)
    assert got.dtype.is_floating_point and got.shape == (P,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,b,score", [("WWWWWWWWWW", "P", -22.0),
                                       ("PPPP", "W", -16.0),
                                       ("A", "AAAA", 4.0 - 10 - 2)])
def test_align_scores_hand_cases(a, b, score):
    """The JAX tests' hand cases: a vertical-to-horizontal gap switch
    costs a second open, not an extension."""
    ac, al = t_al.encode_seqs([a], 10)
    bc, bl = t_al.encode_seqs([b], 10)
    assert float(t_al.align_scores(ac, bc, al, bl)[0]) == score


SEQS = ["K K L L K K L L", "L L K K L L K K", "G I G K F L H S A K K F",
        "A <pad> C", "<unk> <unk>", "F L P L I A G K", "W W W", "M",
        "R R W W R R W W", "K W K L F K K I G A V L K V L"]


def test_clean_and_hydrophobicity_match_jax():
    for s in SEQS:
        assert t_pe.clean_sequence(s) == j_pe.clean_sequence(s)
        rec = t_pe.clean_sequence(s)
        assert t_pe.assign_hydrophobicity(rec) == (
            j_pe.assign_hydrophobicity(rec))
    with pytest.raises(KeyError):
        t_pe.assign_hydrophobicity("AB")
    with pytest.raises(KeyError):
        t_pe.assign_hydrophobicity("A", scale="Kyte")


def test_heuristics_and_composition_match_jax():
    t_ev = t_pe.PeptideEvaluator(device="cpu")
    j_ev = j_pe.PeptideEvaluator()
    for seqs in (SEQS, ["<unk> <unk>", "<pad>"], SEQS[:3]):
        assert t_ev.heuristics(seqs) == j_ev.heuristics(seqs)
        assert t_ev.aa_composition(seqs) == j_ev.aa_composition(seqs)


def test_convert_to_fasta_matches_jax(tmp_path):
    inp = tmp_path / "gen.txt"
    inp.write_text("label: amp\n" + "\n".join(
        s.replace("<pad>", "") + ",0.5" for s in SEQS) + "\n")
    t_pe.PeptideEvaluator(device="cpu").convert_to_fasta(
        str(inp), str(tmp_path / "t.fasta"), 12)
    j_pe.PeptideEvaluator().convert_to_fasta(str(inp),
                                             str(tmp_path / "j.fasta"), 12)
    assert (tmp_path / "t.fasta").read_bytes() == (
        tmp_path / "j.fasta").read_bytes()


def test_similarity_matches_jax():
    """The same random.seed draws the same pairs in both packages; the
    port aligns them on the CPU here."""
    rng = np.random.default_rng(5)
    gen = [" ".join(p) for p in _random_peptides(rng, 60, 1, 25)]
    ref = [" ".join(p) for p in _random_peptides(rng, 40, 2, 25)] + SEQS
    t_ev = t_pe.PeptideEvaluator(device="cpu")
    j_ev = j_pe.PeptideEvaluator()
    random.seed(7)
    got, got_av = t_ev.similarity(gen, ref, matrix_size=30)
    random.seed(7)
    want, want_av = j_ev.similarity(gen, ref, matrix_size=30)
    assert len(got["sim"]) == len(want["sim"]) > 800
    np.testing.assert_allclose(got["sim"], want["sim"], rtol=1e-6)
    assert got_av == pytest.approx(want_av, rel=1e-6)
    random.seed(7)
    pairs = t_ev.similarity_pairs(gen, ref, matrix_size=30)
    assert len(pairs) == len(got["sim"])
    assert t_ev.similarity(["<pad>", "A"], ["K"], 2) == ({"sim": []}, 0.0)
