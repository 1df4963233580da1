"""Checkpoints cross between the JAX package and the port both ways."""

import jax
import numpy as np

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
