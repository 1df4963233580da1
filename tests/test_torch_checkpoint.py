"""Checkpoints cross between the JAX package and the port both ways."""

import jax
import numpy as np
import pytest

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu.models import build_model as j_build
from controlled_peptide_generation_tpu.train import checkpoints as j_ck

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch.api import load_trained_model
from controlled_peptide_generation_tpu_torch.train import checkpoints as t_ck


def _jax_params():
    cfg = JC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = 12, 10, 8
    model = j_build(cfg.model, n_vocab=13, max_seq_len=10)
    return model, model.init_params(jax.random.PRNGKey(5))


def test_jax_save_loads_bit_identical(tmp_path):
    model, params = _jax_params()
    path = str(tmp_path / "model_3.npz")
    j_ck.save(path, {"params": params})
    want = {k: np.asarray(v)
            for k, v in j_ck._flatten({"params": params}).items()}
    got = t_ck.flatten(t_ck.load(path))
    assert {t_ck.keystr(("params",) + p) for p in got} == set(want)
    for p, t in got.items():
        np.testing.assert_array_equal(t.numpy(),
                                      want[t_ck.keystr(("params",) + p)])
    # params_from_jax on the same numpy leaves gives the same tensors
    direct = t_ck.flatten(t_ck.params_from_jax(want))
    for p, t in direct.items():
        assert t.numpy().tobytes() == got[p].numpy().tobytes()

    # the model loader keeps exactly the parts the port runs
    cfg = TC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim, cfg.model.E_args.h_dim = 12, 10, 8
    cfg.max_seq_len = 10
    _, tp = load_trained_model(path, 13, cfg, device="cpu")
    assert set(tp) == {"emb", "enc", "dec"}
    np.testing.assert_array_equal(tp["enc"]["gru_bwd"]["wh"].numpy(),
                                  np.asarray(params["enc"]["gru_bwd"]["wh"]))
    np.testing.assert_array_equal(tp["dec"]["gru"]["wh"].numpy(),
                                  np.asarray(params["dec"]["gru"]["wh"]))


def test_port_save_loads_in_jax(tmp_path):
    model, params = _jax_params()
    flat = {k: np.asarray(v)
            for k, v in j_ck._flatten({"params": params}).items()}
    tp = t_ck.params_from_jax(flat)
    path = str(tmp_path / "model_9.npz")
    t_ck.save(path, tp)
    template = {"params": model.init_params(jax.random.PRNGKey(0))}
    back = j_ck.load(path, template)
    for k, v in j_ck._flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k])
    assert t_ck.latest_step(str(tmp_path)) == 9


def _jax_tfm():
    cfg = JC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim = 12, 10
    cfg.model.E_args.E_class = "transformer"
    cfg.model.G_args.G_class = "transformer"
    model = j_build(cfg.model, n_vocab=13, max_seq_len=10)
    return model, model.init_params(jax.random.PRNGKey(7))


def test_transformer_checkpoint_crosses_both_ways(tmp_path):
    """A JAX transformer checkpoint, whose keys hold list indices
    (['dec']['blocks'][0]['qkv']['w']), loads in the port with the blocks
    as a list, is written back by the port and reloads in the JAX loader
    bit for bit."""
    model, params = _jax_tfm()
    path = str(tmp_path / "model_4.npz")
    j_ck.save(path, {"params": params})
    want = {k: np.asarray(v)
            for k, v in j_ck._flatten({"params": params}).items()}
    assert "['params']['dec']['blocks'][1]['qkv']['w']" in want
    tp = t_ck.load(path)
    assert isinstance(tp["dec"]["blocks"], list)
    assert isinstance(tp["enc"]["blocks"], list)
    got = t_ck.flatten(tp)
    assert ("dec", "blocks", 1, "qkv", "w") in got
    assert {t_ck.keystr(("params",) + p) for p in got} == set(want)
    for p, t in got.items():
        assert t.numpy().tobytes() == want[t_ck.keystr(("params",) + p)
                                           ].tobytes()

    back_path = str(tmp_path / "model_5.npz")
    t_ck.save(back_path, tp)
    template = {"params": model.init_params(jax.random.PRNGKey(0))}
    back = j_ck.load(back_path, template)
    for k, v in j_ck._flatten(back).items():
        assert np.asarray(v).tobytes() == want[k].tobytes(), k

    # the model loader takes every stored path, list indices included
    cfg = TC.default_config()
    cfg.model.z_dim, cfg.model.emb_dim = 12, 10
    cfg.model.E_args.E_class = "transformer"
    cfg.model.G_args.G_class = "transformer"
    cfg.max_seq_len = 10
    _, lp = load_trained_model(path, 13, cfg, device="cpu")
    assert set(lp) == {"emb", "enc", "dec"}
    for p, t in t_ck.flatten(lp).items():
        assert t.numpy().tobytes() == want[t_ck.keystr(("params",) + p)
                                           ].tobytes()


def test_keystr_paths_with_list_indices():
    """keystr/parse_keystr/unflatten take [i] list indices beside ['k']
    dict keys; the GRU's dict-only keys keep their form; an Adam moment's
    path through the blocks parses too."""
    path = ("params", "dec", "blocks", 0, "qkv", "w")
    key = "['params']['dec']['blocks'][0]['qkv']['w']"
    assert t_ck.keystr(path) == key and t_ck.parse_keystr(key) == path
    gru = "['params']['dec']['gru']['wi']"
    assert t_ck.keystr(t_ck.parse_keystr(gru)) == gru
    assert t_ck.parse_state_keystr(
        "['opt'][1][0].mu['dec']['blocks'][1]['ln1']['g']") == (
        "opt", "mu", "dec", "blocks", 1, "ln1", "g")
    tree = t_ck.unflatten({("a", 1, "w"): 1, ("a", 0, "w"): 0, ("b",): 2})
    assert tree == {"a": [{"w": 0}, {"w": 1}], "b": 2}
    assert t_ck.flatten(tree) == {("a", 0, "w"): 0, ("a", 1, "w"): 1,
                                  ("b",): 2}
    with pytest.raises(ValueError):
        t_ck.parse_keystr("['a'].mu")
    with pytest.raises(ValueError):
        t_ck.unflatten({("a", 1): 0})
