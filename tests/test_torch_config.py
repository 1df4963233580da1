"""The port's config copy against the JAX package's: the same flag tree,
dataset specs and derived paths; a JSON round trip; the beam route flag."""

import json

import pytest

from controlled_peptide_generation_tpu import config as JC

from controlled_peptide_generation_tpu_torch import config as TC


def test_same_tree_and_dataset_specs():
    assert TC.to_flat_dict(TC.default_config()) == JC.to_flat_dict(
        JC.default_config())
    for ds in ("amp", "synthetic"):
        t, j = TC.default_config(), JC.default_config()
        t.dataset = j.dataset = ds
        assert TC.dataset_spec(t) == JC.dataset_spec(j)


def test_finalize_derives_the_same_paths():
    argv = ["--runname", "r1", "--vae.n_iter", "1000", "--phase", "2",
            "--hw.decode_mode", "accepted"]
    tcfg, _, tov = TC.parse_and_finalize(argv)
    jcfg, _, jov = JC.parse_and_finalize(argv)
    assert tov == jov
    for key in ("savepath", "loadpath", "vocab_path", "seed"):
        assert tcfg[key] == jcfg[key], key
    assert tcfg.full.s_iter == jcfg.full.s_iter == 1000
    # the port derives no training/eval output paths; the rest agrees
    jflat = JC.to_flat_dict(jcfg)
    assert {k: jflat[k] for k in TC.to_flat_dict(tcfg)} == TC.to_flat_dict(
        tcfg)


def test_json_round_trip(tmp_path):
    cfg, _, ov = TC.parse_and_finalize(["--model.z_dim", "12",
                                        "--hw.gen_dtype", "bfloat16"])
    TC.save_config(ov, cfg, str(tmp_path))
    with open(tmp_path / "config_overrides.json") as fh:
        assert json.load(fh) == {"model.z_dim": 12,
                                 "hw.gen_dtype": "bfloat16"}
    back, _, _ = TC.parse_and_finalize(
        ["--config_json", str(tmp_path / "config_overrides.json")])
    assert back.model.z_dim == 12 and back.hw.gen_dtype == "bfloat16"


@pytest.mark.parametrize("flag,route", [("auto", True), ("on", True),
                                        ("off", False), ("0", False)])
def test_beam_route_flag(flag, route):
    """auto/on parse (the device picks the beam route); off, which asked
    the JAX package for its XLA arm, raises: the port has no plain arm
    on CUDA tensors."""
    if route:
        cfg, _, _ = TC.parse_and_finalize(["--hw.pallas_beam", flag])
        assert cfg.hw.pallas_beam == flag
    else:
        with pytest.raises(ValueError, match="not supported"):
            TC.parse_and_finalize(["--hw.pallas_beam", flag])


def test_bad_tristate_raises():
    with pytest.raises(ValueError):
        TC.parse_and_finalize(["--hw.pallas_beam", "maybe"])
