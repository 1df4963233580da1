"""The port stands alone: it imports neither jax nor the JAX package, nor
sklearn or matplotlib (the H100 machine has neither; the figures import
matplotlib only when they draw), and its entry points refuse to run
without CUDA unless asked for the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "controlled_peptide_generation_tpu_torch"

_PROBE = r"""
import importlib, os, pkgutil, runpy, sys
sys.modules["jax"] = None          # any `import jax` raises ImportError
sys.path.insert(0, {repo!r})
import {pkg} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "{pkg}.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(os.path.join({repo!r}, "chip_smoke.py"), run_name="probe")
bad = sorted(m for m in sys.modules
             if m == "controlled_peptide_generation_tpu"
             or m.startswith("controlled_peptide_generation_tpu."))
print("IMPORTED", len(names))
print("NAMES", sorted(names))
print("BAD", bad)
print("OPTIONAL", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("sklearn", "matplotlib")))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO, pkg=PKG)],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.splitlines()
                 if l.startswith(("IMPORTED", "NAMES", "BAD", "OPTIONAL")))
    assert int(lines["IMPORTED"]) >= 20
    # the data path's modules are among those imported
    for name in ("data.curation", "native"):
        assert repr(f"{PKG}.{name}") in lines["NAMES"], name
    assert lines["BAD"] == "[]"
    assert lines["OPTIONAL"] == "[]"


def test_entry_points_need_cuda_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    from controlled_peptide_generation_tpu_torch import sample_pipeline
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample_pipeline.main(["--savepath_toplevel", str(tmp_path)])
    # chip_smoke.py alone in a directory, and without CUDA: it must fail
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("entry", ["run", "run_from_states",
                                   "load_trained_model", "serve.main",
                                   "build_server", "GenerationServer",
                                   "tsne.eval", "covar.eval", "kde.eval",
                                   "PeptideEvaluator.similarity"])
def test_programmatic_entry_points_default_to_cuda(entry, tmp_path):
    """Called without a device, the programmatic entry points (and the
    serving CLI without --device) ask for CUDA and raise where there is
    none, before any file is read."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    from controlled_peptide_generation_tpu_torch import config as TC
    from controlled_peptide_generation_tpu_torch import pipeline
    from controlled_peptide_generation_tpu_torch import sample_pipeline
    from controlled_peptide_generation_tpu_torch import serve
    from controlled_peptide_generation_tpu_torch.api import (
        load_trained_model)
    from controlled_peptide_generation_tpu_torch.evals import peptide_evals
    from controlled_peptide_generation_tpu_torch.vis import covar, kde, tsne
    cfg, args, _ = TC.parse_and_finalize(
        ["--savepath_toplevel", str(tmp_path)],
        extra_args=sample_pipeline.EXTRA_ARGS)
    calls = {
        "run": lambda: pipeline.run(cfg, args),
        "run_from_states": lambda: pipeline.run_from_states(
            cfg, args, None, None, None, {}),
        "load_trained_model": lambda: load_trained_model(
            str(tmp_path / "model_1.npz"), 24, cfg),
        "serve.main": lambda: serve.main(
            ["--savepath_toplevel", str(tmp_path)]),
        "build_server": lambda: serve.build_server(cfg, args),
        "GenerationServer": lambda: serve.GenerationServer(
            cfg, None, None, None, None),
        "tsne.eval": lambda: tsne.eval({"train": str(tmp_path / "s.h5")}),
        "covar.eval": lambda: covar.eval({"train": str(tmp_path / "s.h5")}),
        "kde.eval": lambda: kde.eval({"train": str(tmp_path / "s.h5")}),
        "PeptideEvaluator.similarity": lambda: (
            peptide_evals.PeptideEvaluator().similarity(["A C"], ["K L"])),
    }
    with pytest.raises(RuntimeError, match="--device cpu"):
        calls[entry]()
