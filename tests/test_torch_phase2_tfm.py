"""Phase-2 training of the transformer family against the JAX package on
the CPU, at a small width (V 13, T 7, B 4, z 6, emb 10, d_model 16, 2
layers (one in the full step), d_ff 32, 2 heads, the classifier's 4
filters a width): the categorical_softmax sampler through the cached step
(tokens, soft rows, the gradient of a scalar of the soft rows with
respect to the decoder), the soft rows' padding mask in the encoder, and
each sub-loss of the full step with its gradients at the JAX package's
params of that sub-stage, the blocks' dropout on (the VAE update trains
both parts with it; the attribute update encodes in eval mode).

Tolerances as in tests/test_torch_phase2.py: losses rtol 1e-5; soft rows
rtol 1e-5 / atol 1e-6; gradients within 1e-4 of each tensor's largest
entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu.ops import sampling as j_samp
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch.ops import sampling as t_samp
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck

from test_torch_phase2 import (B, TLEN, TOL, V, _assert_grad, _models, _t,
                               _to_port, check_full_step)


def _flags(p_dropout=0.0, n_layers=2):
    out = ["--model.E_args.E_class", "transformer",
           "--model.G_args.G_class", "transformer"]
    for part in ("E_args", "G_args"):
        for k, v in (("d_model", 16), ("d_ff", 32), ("n_heads", 2),
                     ("n_layers", n_layers), ("p_dropout", p_dropout)):
            out += [f"--model.{part}.T_args.{k}", str(v)]
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_transformer_soft_sampler_matches_jax(one_thread):
    mode = "categorical_softmax"
    _, _, jm, tm = _models(_flags())
    jparams = jm.init_params(jax.random.PRNGKey(30))
    tp = _to_port(jparams)
    rng = np.random.default_rng(31)
    z = rng.standard_normal((B, 6)).astype(np.float32)
    c = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
    w = rng.standard_normal((B, TLEN + 1, V)).astype(np.float32)
    key = jax.random.PRNGKey(32)

    def scalar(p):
        tok, soft = j_samp.sample_sentences(
            jm, p, key, jnp.asarray(z), jnp.asarray(c), sample_mode=mode,
            temp=1.1)
        return jnp.sum(soft * w), (tok, soft)

    jg, (jtok, jsoft) = jax.grad(scalar, has_aux=True)(jparams)
    noise = np.stack([np.array(jax.random.gumbel(k, (B, V)))
                      for k in jax.random.split(key, TLEN)])
    tok, soft = t_samp.sample_sentences(tm, tp, _t(z), _t(c),
                                        sample_mode=mode, temp=1.1,
                                        noise=_t(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(soft.detach().numpy(), np.asarray(jsoft),
                               **TOL)
    dec = t_ck.flatten(tp["dec"])
    grads = torch.autograd.grad((soft * _t(w)).sum(), list(dec.values()))
    jflat = j_ck._flatten(jg["dec"])
    for p, g in zip(dec, grads):
        _assert_grad(g, jflat[t_ck.keystr(p)], t_ck.keystr(p))


def test_transformer_encodes_soft_rows_as_jax():
    """Soft rows with zeroed (finished) and PAD-dominated rows: mu and
    logvar equal the JAX encoder's, whose padding mask the port copies."""
    _, _, jm, tm = _models(_flags())
    jparams = jm.init_params(jax.random.PRNGKey(33))
    rng = np.random.default_rng(34)
    logits = rng.standard_normal((B, TLEN, V)).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    soft[0, 4:] = 0.0
    soft[1, 3] = np.eye(V, dtype=np.float32)[1]
    want = jm.encode(jparams, jnp.asarray(soft))
    got = tm.encode(_to_port(jparams), _t(soft))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_transformer_full_step_sub_losses_match_jax(one_thread):
    """One layer a stack (the JAX compile of the three gradients is the
    cost), the blocks' dropout on, categorical_softmax."""
    check_full_step(_flags(0.1, n_layers=1) + [
        "--full.G_soft_sample_kwargs.sample_mode", "categorical_softmax"],
        one_seed=40)
