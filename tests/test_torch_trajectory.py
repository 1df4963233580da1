"""Trajectory band: the port's phase-1 trainer against the JAX package's,
each with its own random streams, on one synthetic corpus, over 3 seeds.

Both run their CLI (``main.main``, phase 1) in-process on the CPU at a
small width (z 16, emb 16, encoder H 32, batch 32, lr 3e-3) for 160
iterations, logging every 10; the corpus, its splits and the batches are
the same on both sides (the loaders draw them from the same seeds), the
initial weights and every per-step draw differ (jax.random against
torch.Generator streams). The file takes about 60 s on one worker.

Gates, as ``tests/test_parity_torch.py`` states them for its mirror:

* final reconstruction: the logged train recon of the last 40 iterations
  (4 logs a seed, 12 values a side); the two sides' means within 2 pooled
  standard deviations of those values. Why a window and not the last log:
  with 3 seeds the spread of one log a seed is a poor estimate (runs of
  seeds 0-7 spread 2-3x wider than seeds 0-2 alone), and a last log is one
  batch; the window's values also carry the batch-to-batch noise that the
  comparison of two random streams has to allow;
* reconstruction falls: every seed's final mean below 95% of its first
  log, on both sides;
* MMD-RF stays near 0: |L_wae_mmdrf| < 0.1 at every log of the window."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import main as j_main
from controlled_peptide_generation_tpu_torch import main as t_main

SEEDS = (0, 1, 2)
N_ITER = 160
LOG_EVERY = 10
WINDOW = 40
FLAGS = ["--phase", "1", "--dataset", "synthetic", "--model.z_dim", "16",
         "--model.emb_dim", "16", "--model.E_args.h_dim", "32",
         "--vae.batch_size", "32", "--vae.lr", "3e-3", "--vae.n_iter",
         str(N_ITER), "--vae.cheaplog_every", str(LOG_EVERY),
         "--vae.expsvlog_every", str(N_ITER), "--evals.sample_size", "10",
         "--losses.wae_mmd.rf_dim", "64"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{side: [logged rows of each seed]}: (it, recon, mmdrf)."""
    top = str(tmp_path_factory.mktemp("trajectory"))
    mp = pytest.MonkeyPatch()
    # torch.utils.tensorboard imports TensorFlow here: the port logs
    # without it (as on the card's machine)
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {"jax": [], "port": []}
    try:
        for side, main in (("jax", j_main.main), ("port", t_main.main)):
            for seed in SEEDS:
                argv = FLAGS + [
                    "--datapath", os.path.join(top, "data"),
                    "--savepath_toplevel", os.path.join(top, side),
                    "--tb_toplevel", os.path.join(top, "tb"),
                    "--runname", f"s{seed}", "--seed", str(seed)]
                cfg = main(argv + (["--device", "cpu"] if side == "port"
                                   else []))
                with open(os.path.join(cfg.savepath, "result.json")) as fh:
                    out[side].append([
                        (r["it"], r["train_L_vae_recon"],
                         r["train_L_wae_mmdrf"]) for r in json.load(fh)
                        if "train_L_vae_recon" in r])
    finally:
        torch.set_num_threads(n_threads)
        mp.undo()
    return out


def _window(rows):
    return [r for r in rows if r[0] > N_ITER - WINDOW]


def test_final_recon_within_two_pooled_std(runs):
    vals = {side: np.array([r[1] for rows in runs[side]
                            for r in _window(rows)]) for side in runs}
    assert all(len(v) == len(SEEDS) * WINDOW // LOG_EVERY
               for v in vals.values())
    a, b = vals["jax"], vals["port"]
    pooled = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / 2.0)
    gap = abs(a.mean() - b.mean())
    print(f"final recon: jax {a.mean():.4f} +- {a.std(ddof=1):.4f}, port "
          f"{b.mean():.4f} +- {b.std(ddof=1):.4f}, gap {gap:.4f} < "
          f"{2 * pooled:.4f}")
    assert gap < 2.0 * pooled, (a.tolist(), b.tolist())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_recon_falls_and_mmdrf_stays_near_zero(runs, side):
    for rows in runs[side]:
        assert [r[0] for r in rows] == list(range(0, N_ITER + 1, LOG_EVERY))
        final = _window(rows)
        assert np.all(np.isfinite([r[1:] for r in rows]))
        assert np.mean([r[1] for r in final]) < 0.95 * rows[0][1]
        assert max(abs(r[2]) for r in final) < 0.1
