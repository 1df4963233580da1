"""The plain references against the port on the CPU at tiny sizes: the
parameter tree, the encoders and decoders, the beam searches, Q's fit,
a round's draws and heads, detokenisation and physicochemistry, and
phase-1 training steps. The tests import the port; the references do
not (``test_reference_imports``)."""

import ast
import os

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import beam as ref_beam
from portbench.reference import latent as ref_latent
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train
from portbench.reference.common import generator, onehot
from portbench.reference.physchem import detokenize, physchem

from controlled_peptide_generation_tpu_torch import config as C
from controlled_peptide_generation_tpu_torch.models.rnn_vae import build_model
from controlled_peptide_generation_tpu_torch.ops import beam as port_beam
from controlled_peptide_generation_tpu_torch.train import checkpoints

torch.set_num_threads(2)

ITOS = ["<unk>", "<pad>", "<start>", "<eos>"] + list("ACDEFGHIKLMNPQRSTVWY")
BASE = {"n_vocab": 24, "max_seq_len": 9, "z_dim": 6, "c_dim": 2,
        "emb_dim": 10, "p_word_dropout": 0.3, "rf_dim": 16, "sigma": 7.0,
        "batch_size": 8, "lr": 1e-3, "clip_grad": 5.0,
        "beta": [[1.0, 0], [2.0, 400]], "lambda_logvar_L1": 0.0,
        "lambda_logvar_KL": 1e-3, "itos": ITOS}
CONFIGS = {
    "gru": dict(BASE, family="gru", enc_h_dim=5, p_out_dropout=0.3),
    "transformer": dict(BASE, family="transformer", d_model=16, n_layers=2,
                        n_heads=2, d_ff=24, p_dropout=0.0),
}


def port_model(cfg):
    from portbench.drivers.port import dim_flags
    pcfg, _, _ = C.parse_and_finalize(dim_flags(cfg))
    return build_model(pcfg.model, cfg["n_vocab"], cfg["max_seq_len"]), pcfg


def tokens(cfg, B, seed=0):
    g = torch.Generator().manual_seed(seed)
    T = cfg["max_seq_len"]
    out = torch.full((B, T), 1, dtype=torch.long)
    for b in range(B):
        n = int(torch.randint(2, T - 1, (1,), generator=g))
        out[b, 0] = 2
        out[b, 1:n + 1] = torch.randint(4, 24, (n,), generator=g)
        out[b, n + 1] = 3
    return out


@pytest.fixture(params=sorted(CONFIGS))
def family(request):
    return request.param


def test_param_tree_matches_port(family):
    cfg = CONFIGS[family]
    model, _ = port_model(cfg)
    port = checkpoints.flatten(model.init_params(torch.Generator(), "cpu"))
    ours = checkpoints.flatten(weights.make(cfg, 3, torch.device("cpu")))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in port.items()}


def test_encode_and_decode_match_port(family):
    cfg = CONFIGS[family]
    model, _ = port_model(cfg)
    params = weights.make(cfg, 5, torch.device("cpu"), gain=2.0)
    x = tokens(cfg, 7)
    mu, lv = ref_models.encode(cfg, params, x)
    pmu, plv = model.encode(params, x)
    torch.testing.assert_close(mu, pmu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lv, plv, rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(1)
    z = torch.randn((7, cfg["z_dim"]), generator=g)
    c = onehot(torch.rand((7,), generator=g) < 0.5, 2)
    drop = torch.rand(x.shape, generator=g) < 0.3
    keep = (torch.rand((7, x.shape[1], cfg["z_dim"] + 2), generator=g) < 0.7
            if family == "gru" else None)
    ours = ref_models.decode_logits(cfg, params,
                                    ref_models.word_dropout(x, drop), z, c,
                                    keep, cfg.get("p_out_dropout", 0.0))
    theirs = model.decode_train(params, x, z, c, train=True, word_drop=drop,
                                out_keep=keep)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_beam_matches_port(family):
    cfg = CONFIGS[family]
    model, _ = port_model(cfg)
    params = weights.make(cfg, 9, torch.device("cpu"), gain=3.0)
    g = torch.Generator().manual_seed(2)
    z = 0.7 * torch.randn((40, cfg["z_dim"]), generator=g)
    c = onehot(torch.rand((40,), generator=g) < 0.5, 2)
    toks, score = ref_beam.beam_search(cfg, params, z, c)
    hyps, sc = port_beam.beam_search(model, params, z, c, beam_size=5,
                                     n_best=1, plain=True)
    assert torch.equal(toks, hyps[:, 0])
    torch.testing.assert_close(score, sc[:, 0], rtol=1e-5, atol=1e-4)


def test_mogq_fit_and_round_match_port():
    from controlled_peptide_generation_tpu_torch.latent import (
        class_sampler, density, fused, logreg)
    g = torch.Generator().manual_seed(4)
    mu = 0.5 * torch.randn((300, 6), generator=g)
    lv = torch.full_like(mu, -1.5)
    Q = density.mogQ(mu, lv, n_components=5, z_num_samples=2,
                     gen=generator("cpu", 11, 2))
    q = ref_latent.fit_mogQ(mu, lv, 5, 2, generator("cpu", 11, 2))
    torch.testing.assert_close(q.means, Q.params.means, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q.covars, Q.params.covars, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(q.weights, Q.params.weights, rtol=1e-5,
                               atol=1e-6)
    w = torch.zeros((2, 6))
    w[0, 0], w[1, 1] = 1.0, -0.5
    b = torch.tensor([0.3, -0.4])
    t = torch.tensor([1, 0])
    Q.init_attr_classifiers({"amp": logreg.LogRegParams(w[0], b[0]),
                             "tox": logreg.LogRegParams(w[1], b[1])},
                            {"amp": 1, "tox": 0})
    d_port = fused.round_draws(generator("cpu", 11, 3), Q.params, 50)
    d_ref = ref_latent.round_draws(generator("cpu", 11, 3), q, 50)
    for a, b_ in zip(d_port, d_ref):
        assert torch.equal(a, b_)
    z, probs, accum, accept = class_sampler.rejection_round(
        class_sampler.RejectionDraws(d_port.comp, d_port.eps, d_port.u),
        ("gmm_diag", Q.params), *class_sampler.clf_args(Q)[1:])
    zr = ref_latent.sample(q, d_ref)
    pr, ar = ref_latent.heads(zr, w, b, t)
    torch.testing.assert_close(zr, z, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pr, probs, rtol=1e-5, atol=1e-6)
    assert torch.equal(d_ref.u < ar, accept)


def test_detokenize_and_physchem_match_port():
    from controlled_peptide_generation_tpu_torch.data.vocab import Vocab
    from controlled_peptide_generation_tpu_torch.evals.peptide_evals import (
        modlamp_from_tokens)
    toks = tokens(CONFIGS["gru"], 30, seed=3).numpy()
    toks[5, 3] = 0      # specials inside a row are dropped
    peps = Vocab(ITOS).to_sentences_batch(toks, print_special_tokens=False)
    assert peps == [detokenize(r, ITOS) for r in toks]
    H, uH, ch = modlamp_from_tokens(toks, ITOS)
    ours = np.array([physchem(p) for p in peps])
    np.testing.assert_allclose(ours, np.stack([H, uH, ch], 1), atol=1e-12)


def test_train_steps_match_port(family):
    from controlled_peptide_generation_tpu_torch.ops import losses as L
    from controlled_peptide_generation_tpu_torch.train import train_vae as TV
    from controlled_peptide_generation_tpu_torch.utils import runtime
    cfg = CONFIGS[family]
    model, pcfg = port_model(cfg)
    seed, B = 21, cfg["batch_size"]
    texts = [tokens(cfg, B, seed=s) for s in range(3)]
    params = weights.make(cfg, seed, torch.device("cpu"))
    for leaf in checkpoints.flatten(params).values():
        leaf.requires_grad_(True)
    rf = L.init_rf_basis(runtime.generator("cpu", seed, 1), cfg["z_dim"],
                         cfg["rf_dim"], "cpu")
    step, opt = TV.make_train_step(model, pcfg.vae, pcfg.losses, rf)
    state = opt.init(params)
    losses = []
    for it, x in enumerate(texts):
        draws = TV.draw_step(model, runtime.generator("cpu", seed, it), B,
                             x.shape[1], "cpu")
        losses.append(float(step(params, state, x, it, draws)["L_vae"]))
    ref = weights.make(cfg, seed, torch.device("cpu"))
    out, _ = ref_train.run_steps(cfg, ref, texts, [0, 1, 2], seed)
    np.testing.assert_allclose([o[0] for o in out], losses, rtol=1e-5)
    # Adam turns last-bit differences of near-zero gradients into steps of
    # up to lr, so leaves are compared by the norms of their change
    from portbench.drivers.train import _norm_gap
    p0 = checkpoints.flatten(weights.make(cfg, seed, torch.device("cpu")))
    ours, theirs = checkpoints.flatten(ref), checkpoints.flatten(params)
    assert _norm_gap({k: theirs[k].detach() - p0[k] for k in p0},
                     {k: ours[k] - p0[k] for k in p0}) < 1e-3


def test_reference_imports():
    """The references import neither JAX, the JAX package nor the port."""
    here = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "reference")
    for name in os.listdir(here):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(here, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "controlled_peptide_generation_tpu",
                    "controlled_peptide_generation_tpu_torch"), (name, m)
