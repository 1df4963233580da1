"""The port's flat-vector Adam (``--hw.flat_optimizer on``) against the JAX
package's ``flat_adam`` on the CPU: the ravel order, three updates (the
first clipped) on a nested tree with a list, and the flat train state
crossing between the two packages' checkpoints, with a flip of the Adam
layout across a resume raising the ValueError that names the flag.

Tolerances: params, moments and the norm rtol 1e-5 / atol 1e-6 (fp32 sums
in other orders); checkpoints bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from controlled_peptide_generation_tpu.train import checkpoints as j_ck
from controlled_peptide_generation_tpu.train.opt import flat_adam

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck
from controlled_peptide_generation_tpu_torch.train import opt as t_opt

from test_torch_train import _jax_train_state, _models, _to_port

TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(rng):
    """Nested dicts with unsorted keys and a list (as the transformer's
    blocks): the ravel order is not the insertion order."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"zeta": {"w": f(3, 4), "b": f(4)},
            "blocks": [{"qkv": f(2, 6)} for _ in range(11)],
            "alpha": f(5)}


def test_ravel_order_is_jax_ravel_pytree():
    tree = _tree(np.random.default_rng(0))
    want, _ = ravel_pytree(tree)
    order = t_ck.ravel_order(tree)
    got = np.concatenate([t_ck.flatten(tree)[p].reshape(-1) for p in order])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert order[:3] == [("alpha",), ("blocks", 0, "qkv"),
                         ("blocks", 1, "qkv")]
    assert order[11] == ("blocks", 10, "qkv")


def test_flat_adam_matches_jax():
    """Three steps against flat_adam: the first gradient clipped (norm >
    5), the second not."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [jax.tree.map(lambda p: (s * rng.standard_normal(p.shape))
                          .astype(np.float32), params)
             for s in (4.0, 0.1, 1.0)]
    assert optax.global_norm(grads[0]) > 5 > optax.global_norm(grads[1])
    j_opt = flat_adam(1e-3, 5.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = j_opt.init(jp)
    t_o = t_opt.make_optimizer(TC.parse_and_finalize([])[0].vae, flat=True)
    assert isinstance(t_o, t_opt.FlatAdam) and (t_o.lr, t_o.clip) == (
        1e-3, 5.0)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = t_o.init(tp)
    for g in grads:
        upd, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = t_o.step(tp, jax.tree.map(torch.from_numpy, g), ts)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert int(ts["count"]) == int(js.count)
        np.testing.assert_allclose(ts["m"].numpy(), np.asarray(js.m), **TOL)
        np.testing.assert_allclose(ts["v"].numpy(), np.asarray(js.v), **TOL)


def test_config_selects_the_optimizer():
    """--hw.flat_optimizer on selects the flat Adam; auto and off the
    per-leaf one; other spellings fail at parse time."""
    for value, flat in (("on", True), ("auto", False), ("off", False)):
        cfg, _, _ = TC.parse_and_finalize(["--hw.flat_optimizer", value])
        assert TC.flat_optimizer_enabled(cfg) is flat
        opt = t_opt.make_optimizer(cfg.vae, TC.flat_optimizer_enabled(cfg))
        assert isinstance(opt, t_opt.FlatAdam if flat else t_opt.ClipAdam)
    with pytest.raises(ValueError):
        TC.parse_and_finalize(["--hw.flat_optimizer", "maybe"])


def _jax_flat_state(jparams, steps=2):
    opt = flat_adam(1e-3, 5.0)
    state = opt.init(jparams)
    for s in range(1, steps + 1):
        g = jax.tree.map(lambda p: 0.01 * s * jnp.ones_like(p), jparams)
        upd, state = opt.update(g, state)
        jparams = optax.apply_updates(jparams, upd)
    return jparams, opt, state


def test_jax_flat_state_loads_into_the_port(tmp_path):
    """A JAX flat state (m and v over every leaf, the classifier's first in
    ravel order) loads into the port: the port's leaves' segments, bit for
    bit."""
    _, _, jm, tm = _models()
    jparams, _, jstate = _jax_flat_state(jm.init_params(
        jax.random.PRNGKey(3)))
    path = str(tmp_path / "model_7.npz")
    j_ck.save(path, {"params": jparams, "opt": jstate,
                     "step": jnp.asarray(7)})
    tp0 = tm.init_params(torch.Generator().manual_seed(0))
    opt = t_opt.FlatAdam(1e-3, 5.0)
    tp, ts = t_ck.load_train_state(path, tp0, opt.init(tp0))
    assert int(ts["count"]) == 2
    jflat = {k: np.asarray(v) for k, v in j_ck._flatten(jparams).items()}
    want_m, want_v = [], []
    for p in t_ck.ravel_order(tp):
        np.testing.assert_array_equal(t_ck.flatten(tp)[p].numpy(),
                                      jflat[t_ck.keystr(p)])
    # the JAX vectors cut at the port's leaves by the JAX ravel order
    _, unravel = ravel_pytree(jparams)
    for vec, out in ((jstate.m, want_m), (jstate.v, want_v)):
        tree = {k: np.asarray(v) for k, v in j_ck._flatten(unravel(vec))
                .items()}
        out += [tree[t_ck.keystr(p)].reshape(-1) for p in
                t_ck.ravel_order(tp)]
    np.testing.assert_array_equal(ts["m"].numpy(), np.concatenate(want_m))
    np.testing.assert_array_equal(ts["v"].numpy(), np.concatenate(want_v))
    assert float(ts["v"].abs().sum()) > 0


def test_port_flat_state_loads_into_jax(tmp_path):
    """The port's flat state, after one of its steps, loads into JAX
    checkpoints.load with a flat template over the same leaves (the
    port's, without the classifier), bit for bit."""
    _, _, jm, _ = _models()
    jparams = {k: v for k, v in jm.init_params(jax.random.PRNGKey(4))
               .items() if k != "clf"}
    tparams = _to_port(jparams)
    opt = t_opt.FlatAdam(1e-3, 5.0)
    ts = opt.init(tparams)
    opt.step(tparams, jax.tree.map(lambda p: 0.5 * torch.ones_like(p),
                                   tparams), ts)
    path = str(tmp_path / "model_3.npz")
    t_ck.save(path, tparams, ts, step=3)
    with np.load(path) as data:
        assert {"['opt'].m", "['opt'].v", "['opt'].count"} <= set(data.files)
    template = {"params": jparams, "opt": flat_adam(1e-3, 5.0).init(jparams)}
    back = j_ck.load(path, template, strict=False)
    assert int(back["opt"].count) == 1
    np.testing.assert_array_equal(np.asarray(back["opt"].m),
                                  ts["m"].numpy())
    np.testing.assert_array_equal(np.asarray(back["opt"].v),
                                  ts["v"].numpy())
    flat = j_ck._flatten(back["params"])
    for p, v in t_ck.flatten(tparams).items():
        np.testing.assert_array_equal(np.asarray(flat[t_ck.keystr(p)]),
                                      v.numpy())
    # and the JAX flat update from the loaded state runs on it
    upd, _ = flat_adam(1e-3, 5.0).update(
        jax.tree.map(jnp.ones_like, back["params"]), back["opt"])
    assert np.isfinite(np.asarray(ravel_pytree(upd)[0])).all()


@pytest.mark.parametrize("saved_flat", [True, False])
def test_layout_flip_raises_naming_the_flag(saved_flat, tmp_path):
    """A checkpoint of one Adam layout resumed with the other raises the
    ValueError naming --hw.flat_optimizer, both ways round, in the port
    and in the JAX package (a JAX state loaded into the port too)."""
    _, _, jm, tm = _models()
    tp = tm.init_params(torch.Generator().manual_seed(0))
    flat_opt, leaf_opt = t_opt.FlatAdam(1e-3, 5.0), t_opt.ClipAdam(1e-3, 5.0)
    saver, loader = ((flat_opt, leaf_opt) if saved_flat
                     else (leaf_opt, flat_opt))
    path = str(tmp_path / "model_1.npz")
    t_ck.save(path, tp, saver.init(tp), step=1)
    with pytest.raises(ValueError, match="--hw.flat_optimizer"):
        t_ck.load_train_state(path, tp, loader.init(tp))
    jparams = jm.init_params(jax.random.PRNGKey(5))
    if saved_flat:
        jstate = _jax_flat_state(jparams, 1)[2]
    else:
        jstate = _jax_train_state(jm, 5)[2]
    jpath = str(tmp_path / "model_2.npz")
    j_ck.save(jpath, {"params": jparams, "opt": jstate})
    with pytest.raises(ValueError, match="--hw.flat_optimizer"):
        t_ck.load_train_state(jpath, tp, loader.init(tp))
    tmpl_opt = (optax.chain(optax.clip_by_global_norm(5.0), optax.adam(1e-3))
                if saved_flat else flat_adam(1e-3, 5.0))
    with pytest.raises(ValueError, match="hw.flat_optimizer"):
        j_ck.load(path, {"params": jparams, "opt": tmpl_opt.init(jparams)},
                  strict=False)


def test_flat_state_keys_parse_both_ways():
    for name in ("m", "v", "count"):
        key = t_ck.state_keystr(("opt", name), flat=True)
        assert key == f"['opt'].{name}"
        assert t_ck.parse_state_keystr(key) == ("opt", name)
    assert t_ck.state_keystr(("opt", "count")) == "['opt'][1][0].count"
