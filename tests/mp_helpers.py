"""What tests/test_torch_tp.py, test_torch_pp.py and test_torch_tp3d.py
share: the small transformer family they train (V 13, T 7, batch 4, z 6,
emb 10, d_model 16, d_ff 32, 2 heads; blocks 2 or 4), the JAX package's
draws of a phase-1 step for a key, the JAX runs of its TP / PP / 3D
steps, the spawn of the port's ranks (``tools/mp_check.py``) and the
comparisons.

Tolerance: params and Adam moments within atol 5e-5 / rtol 1e-5 (the JAX
package's bound for a TP step against one device, jnp.allclose's rtol
with ``atol=5e-5``, ``tests/test_tp.py:65``); losses within 1e-5
relative. The attention keys' bias has an exact gradient of 0 (softmax
ignores a shift shared by all keys), so its entries are rounding noise
that Adam scales to up to lr a step either way: they are held within 2 lr
a step, and their moments are left out (as the DP tests do).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import parallel as jpar
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.ops import losses as j_L
from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train import make_train_step

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.models.rnn_vae import (
    build_model as t_build)
from controlled_peptide_generation_tpu_torch.parallel import dist as pdist
from controlled_peptide_generation_tpu_torch.tools import mp_check

from test_torch_phase2 import _decoder_draws, _encoder_draws

V, TLEN, B, Z = 13, 7, 4, 6
TOL = dict(rtol=1e-5, atol=5e-5)
LOSS_RTOL = 1e-5
LR = 1e-3
STEPS = 3


def flags(p_dropout=0.0, n_layers=2, enc="transformer", phase=1):
    """A small model of the transformer family (the encoder a GRU with
    ``enc="gru"``), phase 1's flags or phase 2's."""
    out = ["--model.z_dim", str(Z), "--model.emb_dim", "10",
           "--model.E_args.h_dim", "5", "--max_seq_len", str(TLEN),
           "--losses.wae_mmd.rf_dim", "16", "--model.C_args.num_filters",
           "4", "--phase", str(phase),
           "--model.E_args.E_class", enc,
           "--model.G_args.G_class", "transformer"]
    for part in ("E_args", "G_args"):
        for k, v in (("d_model", 16), ("d_ff", 32), ("n_heads", 2),
                     ("n_layers", n_layers), ("p_dropout", p_dropout)):
            out += [f"--model.{part}.T_args.{k}", str(v)]
    return out


def models(argv):
    jcfg, _, _ = JC.parse_and_finalize(list(argv))
    tcfg, _, _ = TC.parse_and_finalize(list(argv))
    return (jcfg, tcfg, j_build(jcfg.model, n_vocab=V, max_seq_len=TLEN),
            t_build(tcfg.model, n_vocab=V, max_seq_len=TLEN))


def tokens(seed, n=B):
    rng = np.random.default_rng(seed)
    tok = np.full((n, TLEN), 1, np.int32)
    for row in range(n):
        k = int(rng.integers(1, TLEN - 1))
        tok[row, 0] = 2
        tok[row, 1:k + 1] = rng.integers(4, V, k)
        tok[row, k + 1] = 3
    return tok


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return np.array(tree)


def jax_draws(jm, key, n=B):
    """The draws of the JAX phase-1 loss_fn (train_vae.py:52) and forward
    (rnn_vae.py:263) for this key, as the port's draws dict of numpy
    arrays."""
    k_fwd, k_mmd, k_rf, _ = jax.random.split(key, 4)
    kz, kc, kd, ke = jax.random.split(k_fwd, 4)
    return numpy_tree({
        "eps": jax.random.normal(kz, (n, Z)),
        "c_bits": jax.random.bernoulli(kc, 0.5, (n,)),
        "z_prior_mmd": jax.random.normal(k_mmd, (n, Z)),
        "z_prior_rf": jax.random.normal(k_rf, (n, Z)),
        **_decoder_draws(jm, kd, n), **_encoder_draws(jm, ke, n)})


def params_flat(jparams):
    """The JAX params as a checkpoint's flat {key: array} (the classifier
    left out)."""
    return {k: np.asarray(v) for k, v in j_ck._flatten(
        {"params": {k: v for k, v in jparams.items() if k != "clf"}}).items()}


def jax_train(argv, layout, seed=4):
    """STEPS phase-1 steps of the JAX package under ``layout`` ("tp": a
    (1, 2) mesh and make_tp_train_step; "pp": make_pp_model on a 2-stage
    pipe mesh and make_train_step; "3d": make_pp_model and
    make_tp_train_step on get_mesh_3d(1, 2, 2)). Returns the port's case
    of the same inputs (mesh (dp, pp, tp) of the layout) and the JAX
    state and metrics after each step."""
    jcfg, _, jm, _ = models(argv)
    jparams = jm.init_params(jax.random.PRNGKey(seed))
    rf = j_L.init_rf_basis(jax.random.PRNGKey(seed + 1), Z, 16)
    if layout == "pp":
        mesh = (1, 2, 1)
        step, opt = make_train_step(
            jpar.make_pp_model(jm, jpar.get_mesh_pipe(2)), jcfg.vae,
            jcfg.losses, rf, donate=False)
        p, o = jparams, opt.init(jparams)
    else:
        mesh = (1, 1, 2) if layout == "tp" else (1, 2, 2)
        jmesh = (jpar.get_mesh_2d(1, 2) if layout == "tp"
                 else jpar.get_mesh_3d(1, 2, 2))
        model = jm if layout == "tp" else jpar.make_pp_model(jm, jmesh)
        step, _, init_state = jpar.make_tp_train_step(
            model, jcfg.vae, jcfg.losses, rf, jmesh, donate=False)
        p, o = init_state(jparams)
    key = jax.random.PRNGKey(seed + 2)
    steps, want = [], []
    for it in range(STEPS):
        k_it = jax.random.fold_in(key, it)
        text = tokens(seed + 10 + it)
        p, o, m = step(p, o, k_it, jnp.asarray(text),
                       jnp.asarray(it, jnp.int32))
        want.append({"state": {k: np.asarray(v) for k, v in j_ck._flatten(
            {"params": {k: v for k, v in p.items() if k != "clf"},
             "opt": o}).items()},
            "metrics": {k: float(v) for k, v in m.items()}})
        steps.append((text, jax_draws(jm, k_it)))
    case = {"kind": "train", "argv": list(argv), "V": V, "T": TLEN,
            "mesh": mesh, "params": params_flat(jparams),
            "rf": [np.asarray(a) for a in rf], "steps": steps}
    return case, want


def spawn(tmp, world, cases):
    """Every case on ``world`` gloo ranks in one spawn: each rank's list
    of results."""
    path = str(tmp / "cases.pkl")
    with open(path, "wb") as fh:
        pickle.dump(cases, fh)
    pdist.spawn(mp_check.run, world, path, str(tmp))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            out.append(pickle.load(fh))
    return out


def keys_bias(key, shape, heads=2):
    """The entries of a qkv bias that are the attention keys' (head-major
    [heads, q k v, dh]); none for other leaves."""
    mask = np.zeros(shape, bool)
    if key.endswith("['qkv']['b']"):
        mask.reshape(heads, 3, -1)[:, 1] = True
    return mask


def assert_state(got, want, n_steps, skip=("['clf']",)):
    """Params and Adam moments within TOL; the keys' bias within 2 lr a
    step, its moments left out; the count exactly."""
    want = {k: v for k, v in want.items() if not any(s in k for s in skip)}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        v = np.asarray(v)
        noise = keys_bias(k, v.shape)
        if not k.startswith("['opt']"):
            assert np.abs(got[k] - v)[noise].max(initial=0) <= (
                2 * LR * n_steps), k
        np.testing.assert_allclose(got[k][~noise], v[~noise], err_msg=k,
                                   **TOL)


def assert_metrics(got, want, names=None):
    for k in names or want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
