"""Offline dataset curation (reference: data_processing/create_datasets.py).

The port's own copy of the JAX package's ``data/curation.py`` (numpy,
pandas and the standard library; nothing of that package). The same raw
directory and seed give byte-equal CSVs and the same counts. One repair:
a SATPDB dump without the ``Major.Functions`` / ``Sub.functions`` columns
is refused with a ValueError naming them when it is loaded, before any
file is written (the JAX package raises a bare KeyError at their first
use, after the output directory and its first files exist). Every raw
source is read before the output directory is made.

    python -m controlled_peptide_generation_tpu_torch.data.curation \
        --raw DIR --out DIR --seed N

Builds the labeled training corpora from raw public sources:

* DBAASP peptide-card JSONs  -> antimicrobial + cytotoxic concentrations,
* SATPDB csv                 -> curated therapeutic peptides,
* AMPEP pos/neg csvs         -> AMP labels,
* UniProt reviewed txts      -> unlabeled background,
* ToxinPred txts             -> non-toxic negatives,
* (optional) solubility csvs -> sol labels.

Behavioral contract kept from the reference:
  validity: no unusual amino acids, free N/C termini ('#'), 1<=len<=80,
  uppercase, no X (create_datasets.py:10-31);
  unit conversion: 'µM' concentrations -> µg/ml via molecular weight
  (value * MW / 1000), with '>', '<', '=', '±', range mangling (:107-152);
  AMP: pos = dbaasp any activity < 25 + satpdb positives + ampep pos;
       neg = dbaasp all > 100 + ampep neg (:343-460);
  TOX: pos = dbaasp all cytotox < 200 + satpdb 'toxic' entries;
       neg = dbaasp all > 250 + toxinpred (:511-563);
  residue-letter filters (no B/J/O/U/X/Z/lowercase/digits/dashes), len<=50,
  dedup, space-separated residues, shuffled rows (:384-397 etc).

Documented fix vs the reference: the released script emits label values
('amp_pos', 'tox_pos') that its own cfg attribute maps don't contain
(cfg.py:362-369 expects amp_posc/amp_posnc). Here dbaasp-sourced positives
get the *c suffix (concentration-backed) and satpdb/ampep-sourced get *nc,
mirroring how the reference itself maps negatives (dbaasp->amp_negc,
ampep->amp_negnc), so the loader's mapping dicts apply cleanly.

Molecular weight uses average residue masses with optional C-terminal
amidation (modlamp GlobalDescriptor.calculate_MW(amide=True) equivalent).
"""

import glob
import json
import logging
import os

import numpy as np
import pandas as pd

LOG = logging.getLogger(__name__)

# average residue masses (Da); peptide MW = sum + water
AA_MASS = {
    "A": 71.0788, "R": 156.1875, "N": 114.1038, "D": 115.0886,
    "C": 103.1388, "E": 129.1155, "Q": 128.1307, "G": 57.0519,
    "H": 137.1411, "I": 113.1594, "L": 113.1594, "K": 128.1741,
    "M": 131.1926, "F": 147.1766, "P": 97.1167, "S": 87.0782,
    "T": 101.1051, "W": 186.2132, "Y": 163.1760, "V": 99.1326,
}
WATER = 18.01524
AMIDE_DELTA = -0.98402  # -OH -> -NH2

BAD_LETTERS = list("BJOUXZ-")


def molecular_weight(seq, amide=True):
    try:
        mw = sum(AA_MASS[a] for a in seq.strip()) + WATER
    except KeyError:
        return None
    return mw + (AMIDE_DELTA if amide else 0.0)


def parse_concentration(item):
    """'>10' -> 10, '10.7±4.6' -> 10.7, '12.5-25.0' -> 12.5, 'NA' -> None."""
    item = item.replace(">", "").replace("<", "").replace("=", "")
    if item == "NA":
        return None
    if "±" in item:
        item = item[: item.find("±")]
    if "-" in item:
        item = item[: item.find("-")]
    try:
        return float(item.strip())
    except ValueError:
        return None


def _uM_list(entries):
    """Concentration strings from µM-unit activity entries."""
    out = []
    for target in entries or []:
        if target.get("unit") == "µM" and "concentration" in target:
            out.append(target["concentration"])
    return out


def load_dbaasp(raw_dir):
    """Valid DBAASP cards with µg/ml-converted activity/toxicity lists."""
    rows = []
    for j_file in sorted(glob.glob(os.path.join(raw_dir, "dbaasp",
                                                "*.json"))):
        with open(j_file) as fh:
            card = json.load(fh)["peptideCard"]
        if card.get("unusualAminoAcids") is not None:
            continue
        seq = card.get("seq", "")
        if (not seq or not seq.isupper() or "X" in seq
                or not 1 <= len(seq) <= 80
                or card.get("nTerminus") != "#"
                or card.get("cTerminus") != "#"):
            continue
        mw = molecular_weight(seq)
        if mw is None:
            continue

        def converted(entries):
            vals = []
            for c in _uM_list(entries):
                v = parse_concentration(c)
                if v is not None:
                    vals.append(v * mw / 1000.0)
            return vals

        rows.append({
            "seq": seq,
            "converted_activity": converted(card.get("targetActivities")),
            "converted_toxic": converted(
                card.get("hemoliticCytotoxicActivities")),
        })
    return pd.DataFrame(rows, columns=["seq", "converted_activity",
                                       "converted_toxic"])


SATPDB_FUNCTION_COLUMNS = ("Major.Functions", "Sub.functions")


def load_satpdb(raw_dir):
    fn = os.path.join(raw_dir, "satpdb", "satpdb.csv")
    # keep 'None'/'NA' as strings: the filters below compare them literally
    # (modern pandas would otherwise parse both as NaN)
    df = pd.read_csv(fn, keep_default_na=False,
                     na_values=[""]).rename(columns={
        "Sequence": "seq",
        "C.terminal.modification": "cterminal",
        "N.terminal.modification": "nterminal",
        "Peptide.Type": "Peptide_Type",
        "Type.of.Modification": "modi"})
    missing = [c for c in SATPDB_FUNCTION_COLUMNS if c not in df.columns]
    if missing:
        raise ValueError(
            f"{fn}: the SATPDB dump lacks the function column(s) "
            f"{missing}; curation reads {list(SATPDB_FUNCTION_COLUMNS)} "
            "for the toxic positives and the function corpora")
    return df[(df.cterminal == "Free") & (df.nterminal == "Free")
              & (df.Peptide_Type == "Linear") & (df.modi == "None")]


def _seq_ok(seq):
    if not isinstance(seq, str) or not seq or not seq.isupper():
        return False
    if any(b in seq for b in BAD_LETTERS):
        return False
    if any(ch.isdigit() for ch in seq):
        return False
    return all(ch.isalpha() for ch in seq)


def _rows(df, col, fn):
    """Boolean-mask rows; .astype(bool) keeps empty frames as row selection
    (an empty object mask would otherwise select columns)."""
    return df[df[col].apply(fn).astype(bool)]


def _clean(df, maxlen=50):
    ok_len = df.seq.apply(
        lambda s: isinstance(s, str) and len(s) <= maxlen).astype(bool)
    df = df[ok_len]
    df = df[df.seq.apply(_seq_ok).astype(bool)]
    return df.drop_duplicates("seq")


def _any_less(vals, num):
    return any(v < num for v in vals)


def _all_more(vals, num):
    return bool(vals) and all(v >= num for v in vals)


def _all_less(vals, num):
    return bool(vals) and all(v <= num for v in vals)


def curate(raw_dir, out_dir, seed=0):
    """Run the full curation; writes unlab.csv / amp_lab.csv / tox_lab.csv
    (+ sol_lab.csv when solubility inputs exist) under out_dir. Every
    raw source is read before out_dir is made."""
    rng = np.random.default_rng(seed)

    dbaasp = load_dbaasp(raw_dir)
    satpdb = _clean(load_satpdb(raw_dir)
                    .assign(seq=lambda d: d.seq.astype(str)))
    LOG.info("dbaasp valid: %d, satpdb valid: %d", len(dbaasp), len(satpdb))

    # ---- AMP ----
    overlap = dbaasp.merge(satpdb[["seq"]], on="seq", how="inner")
    overlap_neg = set(_rows(overlap, "converted_activity",
                            lambda v: _all_more(v, 100))["seq"])
    satpdb_pos = satpdb[~satpdb.seq.isin(overlap_neg)][["seq"]]
    satpdb_pos = satpdb_pos.assign(amp="amp_posnc")

    dbaasp_pos = _rows(dbaasp, "converted_activity",
                       lambda v: _any_less(v, 25))[["seq"]]
    dbaasp_pos = dbaasp_pos.assign(amp="amp_posc")
    dbaasp_neg = _rows(dbaasp, "converted_activity",
                       lambda v: _all_more(v, 100))[["seq"]]
    dbaasp_neg = dbaasp_neg.assign(amp="amp_negc")

    def read_ampep(name, label):
        fn = os.path.join(raw_dir, "ampep", name)
        df = pd.read_csv(fn, names=["seq", "label"])
        df.seq = df.seq.apply(lambda x: "".join(str(x).split()))
        return df[["seq"]].assign(amp=label)

    ampep_pos = read_ampep("pos_ampep_l1-80.csv", "amp_posnc")
    ampep_neg = read_ampep("neg_ampep_l1-80.csv", "amp_negnc")

    amp_pos = _clean(pd.concat([dbaasp_pos, satpdb_pos, ampep_pos]))
    amp_neg = pd.concat([dbaasp_neg, ampep_neg])
    amp_neg = _clean(amp_neg[~amp_neg.seq.isin(set(amp_pos.seq))])
    amp = pd.concat([amp_pos, amp_neg]).drop_duplicates("seq")
    LOG.info("amp: %d pos, %d neg", len(amp_pos), len(amp_neg))

    # ---- TOX ----
    toxic_satpdb = satpdb[
        satpdb["Major.Functions"].astype(str).str.contains("toxic")
        | satpdb["Sub.functions"].astype(str).str.contains("toxic")]
    dbaasp_tox_pos = _rows(dbaasp, "converted_toxic",
                           lambda v: _all_less(v, 200))[["seq"]]
    dbaasp_tox_pos = dbaasp_tox_pos.assign(tox="tox_posc")
    satpdb_tox_pos = toxic_satpdb[["seq"]].assign(tox="tox_posnc")
    tox_pos = _clean(pd.concat([dbaasp_tox_pos, satpdb_tox_pos]))

    dbaasp_tox_neg = _rows(dbaasp, "converted_toxic",
                           lambda v: _all_more(v, 250))[["seq"]]
    dbaasp_tox_neg = dbaasp_tox_neg.assign(tox="tox_negc")

    def read_txt(sub, name, label):
        fn = os.path.join(raw_dir, sub, name)
        df = pd.read_csv(fn, names=["seq"])
        return df.assign(tox=label)

    toxinpred = pd.concat([
        read_txt("toxicity", "nontoxic_trembl_toxinnpred.txt", "tox_negnc"),
        read_txt("toxicity", "nontoxic_swissprot_toxinnpred.txt",
                 "tox_negnc")])
    tox_neg = pd.concat([dbaasp_tox_neg, toxinpred])
    tox_neg = _clean(tox_neg[~tox_neg.seq.isin(set(tox_pos.seq))])
    tox = pd.concat([tox_pos, tox_neg]).drop_duplicates("seq")
    LOG.info("tox: %d pos, %d neg", len(tox_pos), len(tox_neg))

    # ---- unlabeled ----
    uni = pd.concat([
        pd.read_csv(os.path.join(raw_dir, "uniprot",
                                 "uniprot_reviewed_yes_l1-80.txt"),
                    names=["seq"]),
        pd.read_csv(os.path.join(raw_dir, "uniprot",
                                 "uniprot_reviewed_no_l1-80.txt"),
                    names=["seq"])]).drop_duplicates()
    unlab = _clean(pd.concat([uni[["seq"]], amp[["seq"]], tox[["seq"]]]))

    # ---- solubility (optional inputs), read before any file is written ----
    sol_dir = os.path.join(raw_dir, "solubility")
    sol_parts = []
    if os.path.isdir(sol_dir):
        for name in ("sol_lab_train.csv", "sol_lab_valid.csv",
                     "sol_lab_test.csv"):
            fn = os.path.join(sol_dir, name)
            if os.path.exists(fn):
                sol_parts.append(pd.read_csv(fn, names=["seq", "sol",
                                                        "source"]))

    def spaced(df):
        df = df.copy()
        df["text"] = df.seq.apply(lambda s: " ".join(s))
        return df.drop(columns=["seq"])

    def shuffled(df):
        return df.iloc[rng.permutation(len(df))]

    os.makedirs(out_dir, exist_ok=True)
    amp_out = shuffled(spaced(amp)[["text", "amp"]])
    amp_out.to_csv(os.path.join(out_dir, "amp_lab.csv"), index=False)
    tox_out = shuffled(spaced(tox)[["text", "tox"]])
    tox_out.to_csv(os.path.join(out_dir, "tox_lab.csv"), index=False)
    unlab_out = shuffled(spaced(unlab)[["text"]])
    unlab_out.to_csv(os.path.join(out_dir, "unlab.csv"), index=False)

    sol_n = 0
    if sol_parts:
        sol = _clean(pd.concat(sol_parts)[["seq", "sol"]])
        sol_out = shuffled(spaced(sol)[["text", "sol"]])
        sol_out.to_csv(os.path.join(out_dir, "sol_lab.csv"), index=False)
        sol_n = len(sol_out)
    if sol_n == 0:
        # schema'd placeholder: the full cfg contract names 7 csv files
        # (config.AMP_CSV_FILES / reference cfg.py:340-341); when the raw
        # solubility download is absent the file still exists with the
        # right columns so `--dataset amp` exercises the 7-file path
        pd.DataFrame(columns=["text", "sol"]).to_csv(
            os.path.join(out_dir, "sol_lab.csv"), index=False)
        LOG.info("no solubility inputs under %s; wrote header-only "
                 "sol_lab.csv", sol_dir)

    # ---- SATPDB function-derived single-label corpora ----
    # The reference's released config reads anticancer.csv /
    # antihypertensive.csv / cell-cell.csv with single-value attribute
    # columns (cfg.py:366-368: anticancer=1, antihyper=1, hormone='cell').
    # SATPDB's function annotations are the natural source: its
    # Major.Functions/Sub.functions strings name these categories
    # directly, the same way the tox curation reads its 'toxic' rows.
    def satpdb_func_corpus(substr, col, value, out_name):
        mask = (satpdb["Major.Functions"].astype(str).str.lower()
                .str.contains(substr)
                | satpdb["Sub.functions"].astype(str).str.lower()
                .str.contains(substr))
        df = _clean(satpdb[mask][["seq"]].drop_duplicates("seq"))
        df = df.assign(**{col: value})
        out = shuffled(spaced(df)[["text", col]])
        out.to_csv(os.path.join(out_dir, out_name), index=False)
        LOG.info("%s: %d rows (satpdb %r)", out_name, len(out), substr)
        return len(out)

    n_anticancer = satpdb_func_corpus(
        "anticancer", "anticancer", "anticancer", "anticancer.csv")
    n_antihyper = satpdb_func_corpus(
        "antihypertensive", "antihyper", "antihyper",
        "antihypertensive.csv")
    n_cell = satpdb_func_corpus(
        "cell-cell", "hormone", "cell", "cell-cell.csv")

    return {"amp": len(amp), "tox": len(tox), "unlab": len(unlab),
            "sol": sol_n, "anticancer": n_anticancer,
            "antihyper": n_antihyper, "cell": n_cell}


# ---- synthetic raw sources --------------------------------------------------

_RESIDUES = "ACDEFGHIKLMNPQRSTVWY"
_SATPDB_FUNCTIONS = ["antimicrobial", "toxic", "Anticancer",
                     "antihypertensive", "cell-cell communication",
                     "antibacterial, toxic", "NA", ""]


def write_synthetic_raw(raw_dir, n_cards=200, seed=0, solubility=True):
    """Write synthetic raw sources from ``seed`` under ``raw_dir``, in the
    layout and shapes ``curate`` reads (those of tests/test_curation.py's
    fixture): ``n_cards`` DBAASP peptide cards, a SATPDB csv, AMPEP
    pos/neg csvs, two UniProt and two ToxinPred txts (n_cards // 2 rows
    each) and, with ``solubility``, the three solubility csvs. Every filter
    of the curation meets rows it keeps and rows it drops: termini,
    unusual residues, X and other bad letters, lowercase, lengths past 50
    and 80, µM and other units, the concentration forms of
    ``parse_concentration``, 'NA'/'None' cells and duplicates. Solubility
    rows carry the labels the amp dataset's ``sol`` attribute maps
    (sol_pos / sol_neg)."""
    rng = np.random.default_rng(seed)

    def seq(lo=1, hi=60):
        s = "".join(rng.choice(list(_RESIDUES), int(rng.integers(lo, hi))))
        u = rng.random()
        if u < 0.03:
            s = s[:-1] + str(rng.choice(list("XBZJOU-")))
        elif u < 0.05:
            s = s.lower()
        elif u < 0.06:
            s = s + "".join(rng.choice(list(_RESIDUES), 40))
        return s

    def conc():
        v = float(rng.choice([0.1, 0.5, 2.0, 8.0, 30.0, 120.0, 400.0]))
        v = round(v * float(rng.uniform(0.5, 2.0)), 2)
        return [f"{v}", f">{v}", f"<{v}", f"={v}", f"{v}±{v / 4:.1f}",
                f"{v}-{2 * v}", "NA", "junk"][int(rng.integers(0, 8))]

    def activities():
        return [{"unit": "µM" if rng.random() < 0.85 else "µg/ml",
                 "concentration": conc()}
                for _ in range(int(rng.integers(0, 4)))]

    for sub in ("dbaasp", "satpdb", "ampep", "uniprot", "toxicity"):
        os.makedirs(os.path.join(raw_dir, sub), exist_ok=True)
    for i in range(n_cards):
        card = {"seq": seq(),
                "nTerminus": "#" if rng.random() < 0.9 else "ACT",
                "cTerminus": "#" if rng.random() < 0.85 else "AMD",
                "targetActivities": activities(),
                "hemoliticCytotoxicActivities": activities()}
        if rng.random() < 0.05:
            card["unusualAminoAcids"] = [{"name": "Orn"}]
        with open(os.path.join(raw_dir, "dbaasp", f"{i}.json"), "w") as fh:
            json.dump({"peptideCard": card}, fh)

    n = max(n_cards // 2, 4)

    def pick(options, p=None):
        return [options[j] for j in rng.choice(len(options), n, p=p)]

    pd.DataFrame({
        "Sequence": [seq() for _ in range(n)],
        "C.terminal.modification": pick(["Free", "Amidation"], [0.8, 0.2]),
        "N.terminal.modification": pick(["Free", "Acetylation"],
                                        [0.85, 0.15]),
        "Peptide.Type": pick(["Linear", "Cyclic"], [0.85, 0.15]),
        "Type.of.Modification": pick(["None", "NA", "D-amino"],
                                     [0.8, 0.1, 0.1]),
        "Major.Functions": pick(_SATPDB_FUNCTIONS),
        "Sub.functions": pick(_SATPDB_FUNCTIONS),
    }).to_csv(os.path.join(raw_dir, "satpdb", "satpdb.csv"), index=False)

    for name in ("pos_ampep_l1-80.csv", "neg_ampep_l1-80.csv"):
        with open(os.path.join(raw_dir, "ampep", name), "w") as fh:
            for _ in range(n):
                fh.write(" ".join(seq()) + " ,1\n")
    uni = [seq(5, 80) for _ in range(n)] + ["NA", "None"]
    for name in ("uniprot_reviewed_yes_l1-80.txt",
                 "uniprot_reviewed_no_l1-80.txt"):
        with open(os.path.join(raw_dir, "uniprot", name), "w") as fh:
            fh.write("\n".join(uni[j] for j in rng.choice(len(uni), n))
                     + "\n")
    for name in ("nontoxic_trembl_toxinnpred.txt",
                 "nontoxic_swissprot_toxinnpred.txt"):
        with open(os.path.join(raw_dir, "toxicity", name), "w") as fh:
            fh.write("\n".join(seq() for _ in range(n)) + "\n")
    if solubility:
        os.makedirs(os.path.join(raw_dir, "solubility"), exist_ok=True)
        for name in ("sol_lab_train.csv", "sol_lab_valid.csv",
                     "sol_lab_test.csv"):
            with open(os.path.join(raw_dir, "solubility", name), "w") as fh:
                for _ in range(max(n // 4, 2)):
                    label = ("sol_neg", "sol_pos")[int(rng.integers(0, 2))]
                    fh.write(f"{seq()},{label},src\n")


def main():
    import argparse
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--raw", required=True,
                    help="directory with dbaasp/ satpdb/ ampep/ uniprot/ "
                         "toxicity/ subdirs")
    ap.add_argument("--out", required=True, help="output corpus directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    counts = curate(args.raw, args.out, args.seed)
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
