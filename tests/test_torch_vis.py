"""The port's dump diagnostics (t-SNE, latent discriminators, covar, kde)
against the JAX package's on the CPU.

Both packages read the same seeded states dump (float16 mu / logvar / z,
z_dim 12, two attributes labelled -1 / 0 / 1, a few hundred rows a split).
Tolerances: ``roc_auc`` within 1e-12 of sklearn's with ties; the
discriminators' AUCs within 1e-3 and accuracies within 1/n + 1e-9 (two
Newton solvers agreeing to about 1e-6); Frobenius distances rtol 1e-6;
kde fractions within one Gaussian (1 / n_train: float64 underflow is the
zero, and the sums run in other orders), mean densities rtol 1e-9. The
t-SNE: P within 1e-6 of sklearn's own, every row's perplexity within 1e-3
of 30, trustworthiness no lower than the JAX function's minus 0.02 and KL
under the same P no more than 5% above its embedding's (sklearn's
Barnes-Hut gradient against the port's exact one)."""

import logging
import os
import sys

import h5py
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from sklearn.manifold import _t_sne, trustworthiness
from sklearn.metrics import roc_auc_score
from sklearn.neighbors import NearestNeighbors

from controlled_peptide_generation_tpu.vis import covar as j_covar
from controlled_peptide_generation_tpu.vis import kde as j_kde
from controlled_peptide_generation_tpu.vis import tsne as j_tsne

from controlled_peptide_generation_tpu_torch.vis import covar as t_covar
from controlled_peptide_generation_tpu_torch.vis import kde as t_kde
from controlled_peptide_generation_tpu_torch.vis import tsne as t_tsne

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch, BLAS and OpenMP (sklearn's t-SNE) on one CPU thread: the
    small shapes here are faster so, and a worker of a parallel test run
    does not fight the others for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


Z_DIM = 12
ROWS = {"train": 240, "val": 160, "test": 160}
LABELS = [("amp", {"amp_negc": 0, "amp_posc": 1, "na": -1}),
          ("tox", {"tox_negc": 0, "tox_posc": 1, "na": -1})]


def _states(rng, n):
    """A dump's arrays: labels in {-1, 0, 1} that shift mu, so the
    discriminators have something to find."""
    label = rng.choice([-1, 0, 1], size=(n, len(LABELS)), p=[0.5, 0.25,
                                                             0.25])
    mu = rng.normal(0, 1, (n, Z_DIM)) + 0.8 * label @ rng.normal(
        0, 1, (len(LABELS), Z_DIM))
    logvar = rng.uniform(-12.0, 0.0, (n, Z_DIM))
    z = mu + np.exp(0.5 * logvar) * rng.normal(0, 1, (n, Z_DIM))
    return {"src": rng.integers(4, 24, (n, 10)), "z": z.astype(np.float16),
            "mu": mu.astype(np.float16), "logvar": logvar.astype(np.float16),
            "label": label.astype(np.int64),
            "split": np.zeros((n, 1), np.int64)}


def _write(folder, all_states):
    os.makedirs(folder, exist_ok=True)
    fnames = {}
    for split, st in all_states.items():
        fnames[split] = os.path.join(folder, f"states_{split}_4.h5")
        with h5py.File(fnames[split], "w") as f:
            for k, v in st.items():
                f.create_dataset(k, data=v)
    return fnames


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """The same dump in two folders, one for each package."""
    rng = np.random.default_rng(21)
    all_states = {sp: _states(rng, n) for sp, n in ROWS.items()}
    top = tmp_path_factory.mktemp("vis")
    return (all_states, _write(str(top / "jax"), all_states),
            _write(str(top / "port"), all_states))


@pytest.fixture(scope="module")
def evals(dumps):
    """Each module's eval() of both packages on the dump, matplotlib
    present: {module: (jax result, port result)}."""
    _, j_names, t_names = dumps
    return {
        "tsne": (j_tsne.eval(j_names, LABELS),
                 t_tsne.eval(t_names, LABELS, device="cpu")),
        "covar": (j_covar.eval(j_names), t_covar.eval(t_names,
                                                      device="cpu")),
        "kde": (j_kde.eval(j_names, LABELS),
                t_kde.eval(t_names, LABELS, device="cpu")),
    }


def _written(fnames):
    folder = os.path.dirname(fnames["train"])
    return sorted(f for f in os.listdir(folder) if not f.endswith(".h5"))


def test_eval_writes_the_jax_file_names(dumps, evals):
    """Every figure, the discriminators' JSON and both text files, under
    the JAX package's names."""
    _, j_names, t_names = dumps
    want = _written(j_names)
    assert len(want) == 2 + 1 + 6 + 1 + 2 * 3 + 1
    assert _written(t_names) == want


@pytest.mark.parametrize("module", ["tsne", "covar", "kde"])
def test_eval_without_matplotlib(dumps, evals, module, tmp_path,
                                 monkeypatch, caplog):
    """matplotlib hidden, as on the H100 machine: the same numbers, the
    JSON / TXT artifact, no figure, and one log line naming the figures
    not drawn."""
    all_states, _, t_names = dumps
    names = _write(str(tmp_path), all_states)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    mod = {"tsne": t_tsne, "covar": t_covar, "kde": t_kde}[module]
    args = (names,) if module == "covar" else (names, LABELS)
    with caplog.at_level(logging.INFO, logger="GenerationAPI"):
        got = mod.eval(*args, device="cpu")
    assert got == evals[module][1]
    lines = [r.getMessage() for r in caplog.records
             if "figures not drawn" in r.getMessage()]
    figures = [f for f in _written(t_names) if f.endswith(".png")
               and (f"_{module}_" in f if module != "covar"
                    else "covar" in f or "q_phi" in f)]
    assert len(lines) == 1 and figures
    assert all(f in lines[0] for f in figures)
    written = _written(names)
    assert not any(f.endswith(".png") for f in written)
    suffix = {"tsne": "_latent_discriminator.json",
              "covar": "_frob_dist.txt", "kde": "_kde.txt"}[module]
    assert written == ["states_train_4" + suffix]


def test_roc_auc_matches_sklearn_with_ties():
    rng = np.random.default_rng(3)
    for n in (2, 7, 500):
        y = rng.integers(0, 2, n)
        y[:2] = [0, 1]
        p = np.round(rng.random(n), 1)          # many ties
        got = t_tsne.roc_auc(torch.as_tensor(y), torch.as_tensor(p))
        assert abs(got - roc_auc_score(y, p)) <= 1e-12


def test_latent_discriminator_matches_jax(dumps, evals):
    """Accuracies within one row of the evaluated set: all val rows
    (labelled vs unlabelled), the labelled test rows (between labels)."""
    want, got = evals["tsne"]
    assert list(got) == [a for a, _ in LABELS]
    for ix, (attr, entry) in enumerate(want.items()):
        assert set(got[attr]) == set(entry) == {
            "lab_auc", "lab_acc", "between_auc", "between_acc"}
        for key in ("lab_auc", "between_auc"):
            assert abs(got[attr][key] - entry[key]) <= 1e-3
        n = {"lab_acc": ROWS["val"],
             "between_acc": int((dumps[0]["test"]["label"][:, ix]
                                 != -1).sum())}
        for key, n_te in n.items():
            assert abs(got[attr][key] - entry[key]) <= 1.0 / n_te + 1e-9


def test_build_covar_matches_jax(evals):
    (j_pos, j_unl), (t_pos, t_unl) = evals["covar"]
    np.testing.assert_allclose([t_pos, t_unl], [j_pos, j_unl], rtol=1e-6)


def test_kde_eval_matches_jax(evals):
    want, got = evals["kde"]
    assert list(got) == list(want) and len(want) == 6
    for k, frac in want.items():
        assert abs(got[k] - frac) <= 1.0 / ROWS["train"]


def test_density_stats_match_jax(dumps):
    """Per point: the non-zero fraction within one Gaussian, the mean
    density rtol 1e-9; the dump's spread of variances puts some pairs
    below float64's underflow and some above."""
    st = dumps[0]["train"]
    j_ratio, j_dens = j_kde.density_stats(st["mu"], st["logvar"],
                                          st["z"][:100])
    t_ratio, t_dens = t_kde.density_stats(st["mu"], st["logvar"],
                                          st["z"][:100], device="cpu")
    assert 0.0 < j_ratio.mean() < 1.0
    assert np.abs(t_ratio.numpy() - j_ratio).max() <= 1.0 / ROWS["train"]
    np.testing.assert_allclose(t_dens.numpy(), j_dens, rtol=1e-9)


@pytest.fixture(scope="module")
def clustered():
    """300 points in five clusters, z_dim 12, through float16 as a dump
    stores them."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4, (5, Z_DIM))
    X = centers[rng.integers(0, 5, 300)] + rng.normal(0, 1, (300, Z_DIM))
    return X.astype(np.float16).astype(np.float32)


def test_tsne_p_matches_sklearn(clustered):
    """The joint P against sklearn 1.9.0's own nearest-neighbour P, and
    every row's conditional perplexity against 30."""
    X = clustered
    k = min(len(X) - 1, 91)
    dist = NearestNeighbors(n_neighbors=k).fit(X).kneighbors_graph(
        mode="distance")
    dist.data **= 2
    want = _t_sne._joint_probabilities_nn(dist, 30.0, 0).toarray()
    Xt = torch.as_tensor(X, dtype=torch.float64)
    P = t_tsne.joint_probabilities(Xt)
    assert np.abs(P.numpy() - want).max() <= 1e-6
    cond = t_tsne.conditional_probabilities(
        t_tsne.nearest_sqdistances(Xt, k)[0])
    entropy = -(cond * torch.log(cond.clamp_min(1e-300))).sum(dim=1)
    assert float((torch.exp(entropy) - 30.0).abs().max()) <= 1e-3


def test_tsne_neighbours_break_ties_by_index():
    """A dump whose z is mu repeats rows: among equal distances the lower
    index comes first, so every device picks the same neighbours."""
    X = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 0.0],
                      [0.0, 1.0], [-1.0, 0.0]], dtype=torch.float64)
    sqd, idx = t_tsne.nearest_sqdistances(X, 4)
    assert idx[0].tolist() == [1, 2, 3, 4]
    assert idx[1].tolist() == [3, 0, 2, 4]
    assert sqd[1].tolist() == [0.0, 1.0, 2.0, 2.0]


def test_tsne_quality_against_jax(clustered):
    """The port's embedding against the JAX function's (sklearn's TSNE)
    on the same points: trustworthiness (k 5) and KL under the same P."""
    states = {"z": clustered}
    want = j_tsne.compute_tsne_embeddings(states)
    got = t_tsne.compute_tsne_embeddings(states, device="cpu")
    assert got.shape == want.shape == (300, 2) and np.isfinite(got).all()
    assert trustworthiness(clustered, got, n_neighbors=5) >= (
        trustworthiness(clustered, want, n_neighbors=5) - 0.02)
    P = t_tsne.joint_probabilities(torch.as_tensor(clustered,
                                                   dtype=torch.float64))

    def kl(Y):
        return float(t_tsne.kl_and_grad(torch.as_tensor(Y).double(), P)[0])

    assert kl(got) <= 1.05 * kl(want)
