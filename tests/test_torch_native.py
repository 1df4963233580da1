"""The port's native tokenizer (``native/``) against the JAX package's
Python tokenizer, and the port loader's tokens against the JAX loader's.

The extension is built from ``native/_tokenizer.c`` at its first use (the
first test here builds it, a second or so of gcc). Its rows equal the JAX
``data/vocab.py`` ``Vocab.to_ix`` path on a synthetic corpus, on an
unknown token, on multi-character tokens, on the special tokens to_ix
drops and on whitespace other than the space; the port loader's tokens
equal the JAX loader's on the same csv files (that loader runs its Python
path here: the JAX extension is not built), and equal its own plain path.
A failed build raises with the compiler's output; builds started together
in several processes all load a whole library."""

import os
import subprocess
import sys

import numpy as np
import pytest

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.data import loader as j_loader
from controlled_peptide_generation_tpu.data import synthetic as j_synth
from controlled_peptide_generation_tpu.data.vocab import Vocab as JVocab

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import native
from controlled_peptide_generation_tpu_torch.data import loader as t_loader
from controlled_peptide_generation_tpu_torch.data.vocab import (
    EOS_IDX, PAD_IDX, START_IDX, UNK_IDX)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_rows(texts, vocab, max_len):
    return np.array([vocab.to_ix(t, fix_length=max_len) for t in texts],
                    dtype=np.int32).reshape(len(texts), max_len)


@pytest.mark.parametrize("max_len", [2, 8, 25])
def test_native_matches_jax_python_path(max_len):
    rng = np.random.default_rng(max_len)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    texts = [" ".join(rng.choice(aa, int(rng.integers(0, 40))))
             for _ in range(500)]
    texts += ["", "A", "A " * 40, "  K   L  ", "A Z C", "K\tK\nK\x1cA",
              "A <start> C <eos> D", "ALA K ALA", "µ A K\xa0C", "A C"]
    v = JVocab(["<unk>", "<pad>", "<start>", "<eos>", "ALA", "µ"] + aa)
    got = native.tokenize_corpus(texts, v.stoi, max_len)
    assert got.dtype == np.int32 and got.shape == (len(texts), max_len)
    np.testing.assert_array_equal(got, _jax_rows(texts, v, max_len))
    np.testing.assert_array_equal(
        native.tokenize_corpus_reference(texts, v, max_len), got)


def test_native_unknown_and_multichar_tokens():
    v = JVocab(["<unk>", "<pad>", "<start>", "<eos>", "ALA", "K", "C"])
    got = native.tokenize_corpus(["A Z C", "ALA K ALA"], v.stoi, 8)
    assert list(got[0]) == [START_IDX, UNK_IDX, UNK_IDX, 6, EOS_IDX] + [
        PAD_IDX] * 3
    assert list(got[1, :5]) == [START_IDX, 4, 5, 4, EOS_IDX]
    np.testing.assert_array_equal(
        got, _jax_rows(["A Z C", "ALA K ALA"], v, 8))


def test_port_loader_tokens_equal_jax_loader(tmp_path):
    path = str(tmp_path / "synthetic")
    j_synth.ensure(path, n_unlab=300, n_amp=120, n_tox=120)
    kw = dict(mbsize=8, max_seq_len=25)
    jcfg, tcfg = JC.default_config(), TC.default_config()
    jcfg.dataset = tcfg.dataset = "synthetic"
    jspec, tspec = JC.dataset_spec(jcfg), TC.dataset_spec(tcfg)
    jspec["data_path"] = tspec["data_path"] = path
    want = j_loader.AttributeDataLoader(**kw, **jspec)
    got = t_loader.AttributeDataLoader(**kw, **tspec)
    plain = native.tokenize_corpus_reference(
        [r["text"] for r in got.rows], got.vocab, kw["max_seq_len"])
    assert got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(plain, want.tokens)
    assert got.vocab.itos == want.vocab.itos


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_ext", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", "gcc --no-such-flag")
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.tokenize_corpus(["A"], {"A": 4}, 4)
    monkeypatch.setenv("CC", os.path.join(str(tmp_path), "no-such-cc"))
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        native.build()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
from controlled_peptide_generation_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
print(native.tokenize_corpus(["A C", "C"], {{"A": 4, "C": 5}}, 4).tolist())
"""


def test_parallel_first_builds_load_a_whole_library(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[[2, 4, 5, 3], [2, 5, 3, 1]]"
    files = os.listdir(tmp_path)
    assert len([f for f in files if f.endswith(".so")]) == 1, files
    assert not [f for f in files if f.endswith(".tmp")], files
