"""t-SNE scatter and latent discriminators of a states dump, on the device.

Per attribute: a 2-D t-SNE of the dumped z states colored by label, and
logistic-regression latent discriminators reporting (a) labeled-vs-
unlabeled AUC and accuracy on val and (b) between-label AUC and accuracy
on test, saved as ``<states>_latent_discriminator.json``. As in the JAX
package, each metric is stored under its own key (the reference stored
``lab_auc`` under the between-label key). The discriminators are fit with
the Newton solver (``latent/logreg.py``) on the device.

The t-SNE follows sklearn 1.9.0's ``TSNE(n_components=2, init="pca")``,
which the JAX package calls: perplexity 30; the joint P built from the
``min(N-1, 91)`` nearest neighbours' squared Euclidean distances by a
per-row binary search on the perplexity, then P + P^T normalized; early
exaggeration 12 for the first 250 iterations at momentum 0.5, then
momentum 0.8 up to 1,000 iterations; learning rate ``max(N / 12 / 4,
50)`` with the delta-bar-delta gains (min gain 0.01); the PCA init scaled
to a first-column std of 1e-4; sklearn's stopping rules, checked every 50
iterations. Its gradient is the exact one over all pairs, a [N, N] matrix
an iteration (N <= 2,000 by default), where sklearn approximates it by
Barnes-Hut (angle 0.5): P equals sklearn's, the embedding agrees in
quality (KL, trustworthiness), not in coordinates. Everything is float64;
the descent's sums are tree sums of elementwise adds, so the card gives
the CPU's bits (barring a float32 rounding boundary in P or the init).
"""

import json
import logging
import math
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from ..latent import logreg
from ..utils import runtime
from . import build_index, figures

LOG = logging.getLogger("GenerationAPI")

PERPLEXITY = 30.0
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
# sklearn's perplexity search: 100 steps, its C float constants
SEARCH_STEPS = 100
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
EPSILON_DBL = float(np.float32(1e-8))
MACHINE_EPSILON = float(np.finfo(np.float64).eps)


class TSNEResult(NamedTuple):
    embedding: torch.Tensor   # [N, 2] float64
    P: torch.Tensor           # [N, N] joint probabilities, float64
    kl: float                 # KL(P || Q) at the last check, as sklearn's
    n_iter: int               # iterations run (sklearn's n_iter_ + 1)


def tree_sum(x, dim):
    """Sum over ``dim`` by pairwise halving with elementwise adds: the same
    bits on the CPU and on the card, where torch's reductions each sum in
    an order of their own."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << (n.bit_length() - 1)           # the largest power of 2 <= n
    if p < n:
        x = torch.cat([x[..., :n - p] + x[..., p:], x[..., n - p:p]], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def nearest_sqdistances(X, k):
    """Each row's k nearest other rows: their squared Euclidean distances
    [N, k] (float32, as sklearn hands them to the search) and indices.
    Among equal distances the lower index comes first (a stable sort), so
    the CPU and the card pick the same neighbours; a dump whose z is mu
    holds duplicate rows, and so exact ties."""
    d = torch.cdist(X, X, compute_mode="donot_use_mm_for_euclid_dist")
    d.fill_diagonal_(float("inf"))
    dist, idx = torch.sort(d, dim=1, stable=True)
    return (dist[:, :k] ** 2).to(torch.float32), idx[:, :k]


def conditional_probabilities(sqd, perplexity=PERPLEXITY):
    """sklearn's ``_binary_search_perplexity``, all rows at once: for each
    row the precision beta whose conditional distribution over its
    neighbours has entropy log(perplexity) within the tolerance (up to 100
    bisection steps). Returns P(j | i) [N, k], float64."""
    d = sqd.to(torch.float64)
    col = (d.shape[0], 1)
    beta = torch.ones(col, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(col, dtype=torch.bool, device=d.device)
    P = torch.zeros_like(d)
    target = math.log(perplexity)
    for step in range(SEARCH_STEPS):
        Pi = torch.exp(-d * beta)
        s = Pi.sum(dim=1, keepdim=True)
        s = torch.where(s == 0.0, EPSILON_DBL, s)
        Pi = Pi / s
        diff = (torch.log(s) + beta * (d * Pi).sum(dim=1, keepdim=True)
                - target)
        P = torch.where(done, P, Pi)
        done = done | (diff.abs() <= PERPLEXITY_TOLERANCE)
        up = diff > 0.0
        lo = torch.where(~done & up, beta, lo)
        hi = torch.where(~done & ~up, beta, hi)
        raised = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0)
        lowered = torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0)
        beta = torch.where(done, beta, torch.where(up, raised, lowered))
        if step % 10 == 9 and bool(done.all()):
            break
    return P


def joint_probabilities(X, perplexity=PERPLEXITY):
    """sklearn's ``_joint_probabilities_nn`` as a dense [N, N] float64
    matrix: the conditional P over the min(N-1, 3*perplexity+1) nearest
    neighbours, P + P^T, normalized to sum 1. The conditional P is rounded
    to float32 first: exp and log differ in their last bits between the
    CPU and the card, and the descent amplifies any difference."""
    N = X.shape[0]
    sqd, idx = nearest_sqdistances(X, min(N - 1, int(3.0 * perplexity + 1)))
    cond = conditional_probabilities(sqd, perplexity).to(torch.float32)
    P = torch.zeros((N, N), dtype=torch.float64, device=X.device)
    P.scatter_(1, idx, cond.to(torch.float64))
    P = P + P.T
    return P / torch.clamp(tree_sum(tree_sum(P, 1), 0), min=MACHINE_EPSILON)


def kl_and_grad(Y, P, with_kl=True):
    """KL(P || Q) of the embedding Y [N, 2] (Student-t Q, one degree of
    freedom; None unless ``with_kl``) and its exact gradient, as sklearn's
    ``_kl_divergence``. The gradient is elementwise operations and tree
    sums only, so a descent gives the same bits on the CPU and the card."""
    dx = Y[:, None, 0] - Y[None, :, 0]
    dy = Y[:, None, 1] - Y[None, :, 1]
    W = 1.0 / (dx * dx + dy * dy + 1.0)
    W.fill_diagonal_(0.0)
    Q = torch.clamp(W / tree_sum(tree_sum(W, 1), 0), min=MACHINE_EPSILON)
    kl = None
    if with_kl:
        kl = (P * torch.log(torch.clamp(P, min=MACHINE_EPSILON) / Q)).sum()
    PQd = (P - Q) * W
    return kl, 4.0 * torch.stack([tree_sum(PQd * dx, 1),
                                  tree_sum(PQd * dy, 1)], dim=1)


def pca_init(X):
    """sklearn's PCA init: the two leading principal components (each
    component's largest entry made positive, as ``svd_flip`` does), rounded
    to float32 as sklearn rounds them, scaled so that the first column's
    std is 1e-4."""
    Xc = X - X.mean(dim=0)
    _, vecs = torch.linalg.eigh(Xc.T @ Xc / (X.shape[0] - 1))
    V = vecs[:, [-1, -2]].T
    V = V * torch.sign(V.gather(1, V.abs().argmax(dim=1, keepdim=True)))
    Y = (Xc @ V.T).to(torch.float32).to(torch.float64)
    N = Y.shape[0]
    y0 = Y[:, 0] - tree_sum(Y[:, 0], 0) / N
    return Y / torch.sqrt(tree_sum(y0 * y0, 0) / N) * 1e-4


def _gradient_descent(Y, P, it, max_iter, momentum, learning_rate,
                      n_iter_without_progress):
    """sklearn's ``_gradient_descent``: momentum and per-coordinate gains,
    the error and the gradient's norm checked every N_ITER_CHECK
    iterations. Returns (Y, error, last iteration)."""
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        with_kl = check or i == max_iter - 1
        kl, grad = kl_and_grad(Y, P, with_kl)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                            min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        Y = Y + update
        if with_kl:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return Y, error, i


def fit_tsne(X, perplexity=PERPLEXITY):
    """The 2-D t-SNE of X [N, D] on X's device. Returns a TSNEResult."""
    X = X.to(torch.float64)
    N = X.shape[0]
    P = joint_probabilities(X, perplexity)
    learning_rate = max(N / EARLY_EXAGGERATION / 4.0, 50.0)
    Y, _, it = _gradient_descent(
        pca_init(X), P * EARLY_EXAGGERATION, 0, EXPLORATION_ITERS, 0.5,
        learning_rate, EXPLORATION_ITERS)
    Y, kl, it = _gradient_descent(Y, P, it + 1, MAX_ITER, 0.8, learning_rate,
                                  N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(Y, P, kl, it + 1)


def compute_tsne_embeddings(states, max_points=2000, seed=0, device="cuda"):
    """[n, 2] numpy t-SNE of the first ``max_points`` z states, computed on
    ``device``. ``seed`` is sklearn's ``random_state``, kept for the JAX
    package's signature: the PCA init it seeds is deterministic here, as
    sklearn's is at these shapes."""
    del seed
    z = torch.as_tensor(states["z"][:max_points].astype(np.float32),
                        device=device)
    return fit_tsne(z).embedding.cpu().numpy()


def build_tsne(states, fname, label_dict, device="cuda"):
    """The t-SNE figure of each attribute (``<states>_tsne_<attr>.png``),
    where matplotlib is installed. Returns the embedding."""
    tsne = compute_tsne_embeddings(states, device=device)
    paths = [fname[:-3] + f"_tsne_{attr_name}.png"
             for attr_name, _ in label_dict]
    plt = figures.pyplot(paths) if paths else None
    if plt is None:
        return tsne
    color_cycle = ["#000000", "#FF6859", "#1EB980", "#72DEFF", "#FFCF44"]
    all_labels = states["label"][:len(tsne)]
    for attr_ix, (attr_name, value_key) in enumerate(label_dict):
        legend = defaultdict(str)
        for label_name, label_int in value_key.items():
            if legend[label_int]:
                legend[label_int] += "/"
            legend[label_int] += label_name
        data_points = defaultdict(list)
        for i in range(len(tsne)):
            data_points[legend[all_labels[i][attr_ix]]].append(tsne[i])
        plt.figure(figsize=(10, 10))
        for ix, (lab, dat) in enumerate(data_points.items()):
            d = np.stack(dat)
            plt.scatter(d[:, 0], d[:, 1],
                        color=color_cycle[ix % len(color_cycle)],
                        alpha=0.5, label=lab)
        plt.legend()
        plt.title(f"t-SNE of z, colored by {attr_name}")
        plt.savefig(paths[attr_ix], dpi=150)
        plt.close()
        LOG.info("Saved t-SNE for %s", attr_name)
    return tsne


def roc_auc(y, p):
    """Area under the ROC curve of scores p for binary labels y, in the
    rank (Mann-Whitney) form with ties counted as one half: equal to
    sklearn's ``roc_auc_score`` for binary labels. float64 on p's
    device."""
    p = torch.as_tensor(p).to(torch.float64)
    pos = torch.as_tensor(y, device=p.device) > 0.5
    n_pos = pos.sum().to(torch.float64)
    n_neg = pos.numel() - n_pos
    sp, order = torch.sort(p)
    _, inv, counts = torch.unique_consecutive(
        sp, return_inverse=True, return_counts=True)
    # a tie group holding ranks e-c+1 .. e shares their mean, e - (c-1)/2
    c = counts.to(torch.float64)
    mean_rank = torch.cumsum(c, 0) - (c - 1.0) / 2.0
    r_pos = mean_rank[inv][pos[order]].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _fit_and_auc(X_tr, y_tr, X_te, y_te):
    clf, _ = logreg.fit(X_tr, y_tr)
    p = logreg.predict_proba(clf, X_te)[:, 1]
    auc = roc_auc(y_te, p)
    acc = ((p > 0.5) == (y_te > 0.5)).to(torch.float64).mean()
    return auc, float(acc)


def build_latent_discriminator(states, fname, label_dict, val_data,
                               test_data, device="cuda"):
    """For each attribute: labeled-vs-unlabeled AUC and accuracy, and
    pos-vs-neg AUC and accuracy, trained on the train states' mu and
    evaluated on val / test states, on ``device``."""
    def on_device(st):
        return (torch.as_tensor(st["mu"].astype(np.float32), device=device),
                torch.as_tensor(st["label"], device=device))

    def n_classes(y):
        return torch.unique(y).numel()

    train, val, test = (on_device(st) for st in (states, val_data,
                                                 test_data))
    report = {}
    for attr_ix, (attr_name, _) in enumerate(label_dict):
        def xy(st, mode):
            mu, lab = st[0], st[1][:, attr_ix]
            if mode == "lab_vs_unl":
                return mu, (lab != -1).to(torch.float32)
            sel = lab != -1
            return mu[sel], (lab[sel] == 1).to(torch.float32)

        entry = {}
        X_tr, y_tr = xy(train, "lab_vs_unl")
        X_te, y_te = xy(val, "lab_vs_unl")
        if n_classes(y_tr) == 2 and n_classes(y_te) == 2:
            auc, acc = _fit_and_auc(X_tr, y_tr, X_te, y_te)
            entry["lab_auc"] = auc
            entry["lab_acc"] = acc
        X_tr, y_tr = xy(train, "between")
        X_te, y_te = xy(test, "between")
        if n_classes(y_tr) == 2 and n_classes(y_te) == 2:
            auc, acc = _fit_and_auc(X_tr, y_tr, X_te, y_te)
            entry["between_auc"] = auc
            entry["between_acc"] = acc
        report[attr_name] = entry
        LOG.info("latent discriminator %s: %s", attr_name, entry)
    out = fname[:-3] + "_latent_discriminator.json"
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    return report


def eval(fnames, label_dict=(), device="cuda"):  # noqa: A001 - JAX name
    """The t-SNE figures and the discriminators' report of the states
    dumps ``fnames`` ({split: path}) on ``device`` (CUDA unless the caller
    asks for the CPU). Returns the report."""
    device = runtime.setup(device)
    fname = fnames["train"]
    states = build_index.read_states(fname)
    LOG.info("Starting with TSNE now.")
    build_tsne(states, fname, label_dict, device)
    LOG.info("Running latent discriminator now.")
    val_states = build_index.read_states(fnames["val"])
    test_states = build_index.read_states(fnames["test"])
    return build_latent_discriminator(states, fname, label_dict, val_states,
                                      test_states, device)
