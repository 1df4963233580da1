"""The port's curation (``data/curation.py``) against the JAX package's.

On raw sources written from a numpy seed (``write_synthetic_raw``, the
shapes of ``tests/test_curation.py``'s fixture), with seeds 0 and 1 (the
second with the solubility inputs, the first without: a header-only
sol_lab.csv), both ``curate`` calls write the seven CSVs byte-equal and
return equal counts; so they do on that fixture. The unit and threshold
helpers agree on each case. A SATPDB dump without its two function
columns: the JAX package raises a KeyError, the port a ValueError naming
them, before any file is written."""

import filecmp
import json
import os
import subprocess
import sys

import pandas as pd
import pytest

from controlled_peptide_generation_tpu.data import curation as j_cur
from controlled_peptide_generation_tpu_torch.data import curation as t_cur

from tests.test_curation import raw_dir  # noqa: F401  (the fixture)

OUTPUTS = ["amp_lab.csv", "tox_lab.csv", "unlab.csv", "sol_lab.csv",
           "anticancer.csv", "antihypertensive.csv", "cell-cell.csv"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_outputs(raw, tmp_path, seed):
    want = j_cur.curate(raw, str(tmp_path / "jax"), seed)
    got = t_cur.curate(raw, str(tmp_path / "port"), seed)
    assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(OUTPUTS)
    for name in OUTPUTS:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_curate_byte_equal_to_jax(seed, tmp_path):
    raw = str(tmp_path / "raw")
    t_cur.write_synthetic_raw(raw, n_cards=240, seed=seed,
                              solubility=seed == 1)
    counts = _assert_same_outputs(raw, tmp_path, seed)
    # every corpus non-empty, the solubility one only with its inputs
    assert all(counts[k] > 0 for k in counts if k != "sol")
    assert (counts["sol"] > 0) == (seed == 1)
    header = pd.read_csv(tmp_path / "port" / "sol_lab.csv")
    assert list(header.columns) == ["text", "sol"]


def test_curate_fixture_byte_equal_to_jax(raw_dir, tmp_path):  # noqa: F811
    counts = _assert_same_outputs(raw_dir, tmp_path, 0)
    assert counts["sol"] == 0
    tox = pd.read_csv(tmp_path / "port" / "tox_lab.csv")
    # the filtered cards (amidated terminus, unusual residues, X) appear
    # nowhere, and the thresholds label as the JAX contract says
    seqs = {t.replace(" ", "") for t in
            pd.read_csv(tmp_path / "port" / "unlab.csv").text}
    assert not seqs & {"KLKLKLKLKL", "RRRRRRRRRR", "KKXKK"}
    by_seq = {r.text.replace(" ", ""): r.tox for r in tox.itertuples()}
    assert by_seq["WWCCWWCCWW"] == "tox_posc"
    assert by_seq["RRWWRRWWRR"] == "tox_posnc"


@pytest.mark.parametrize("item", [">10", "<1.25", "=2", "10.7±4.6",
                                  "12.5-25.0", "NA", "junk", " 3.5 ",
                                  ">=0.5", "1e2"])
def test_parse_concentration_matches_jax(item):
    assert t_cur.parse_concentration(item) == j_cur.parse_concentration(item)


@pytest.mark.parametrize("seq,amide", [("GG", False), ("GG", True),
                                       ("KKLLKKLLKK", True), ("GX", True),
                                       (" WWCC ", False), ("", True)])
def test_molecular_weight_matches_jax(seq, amide):
    assert (t_cur.molecular_weight(seq, amide)
            == j_cur.molecular_weight(seq, amide))


@pytest.mark.parametrize("vals,num", [([], 25), ([24.9], 25), ([25.0], 25),
                                      ([101, 99], 100), ([100, 300], 100),
                                      ([200, 199], 200)])
def test_thresholds_match_jax(vals, num):
    for name in ("_any_less", "_all_more", "_all_less"):
        assert (getattr(t_cur, name)(vals, num)
                == getattr(j_cur, name)(vals, num)), name


def test_load_dbaasp_filters_as_jax(raw_dir):  # noqa: F811
    got, want = t_cur.load_dbaasp(raw_dir), j_cur.load_dbaasp(raw_dir)
    assert list(got.seq) == list(want.seq) == [
        "KKLLKKLLKK", "AAAGGGAAAG", "WWCCWWCCWW", "GGGSSSGGGS"]
    assert list(got.converted_activity) == list(want.converted_activity)
    assert list(got.converted_toxic) == list(want.converted_toxic)


def test_satpdb_without_function_columns_refused(raw_dir, tmp_path):  # noqa: F811,E501
    fn = os.path.join(raw_dir, "satpdb", "satpdb.csv")
    pd.read_csv(fn).drop(columns=["Major.Functions", "Sub.functions"]
                         ).to_csv(fn, index=False)
    with pytest.raises(KeyError):
        j_cur.curate(raw_dir, str(tmp_path / "jax"), 0)
    out = tmp_path / "port"
    with pytest.raises(ValueError, match=r"Major\.Functions.*Sub\.functions"):
        t_cur.curate(raw_dir, str(out), 0)
    assert not out.exists()


def test_cli_prints_the_counts(tmp_path):
    raw = str(tmp_path / "raw")
    t_cur.write_synthetic_raw(raw, n_cards=40, seed=3, solubility=False)
    out = subprocess.run(
        [sys.executable, "-m",
         "controlled_peptide_generation_tpu_torch.data.curation", "--raw",
         raw, "--out", str(tmp_path / "out"), "--seed", "3"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts == j_cur.curate(raw, str(tmp_path / "jax"), 3)
