"""Phase-1 train steps/s of two checkouts on one card, in alternating runs.

    python -m controlled_peptide_generation_tpu_torch.tools.paired_steps \\
        BASE CHANGE [--pairs 10] [--steps 100] [--unroll N] \\
        [--base-unroll N] [flags of main.py]

Runs each checkout's ``tools/profile_train.py`` from the checkout's root,
one process a run, in the order base, change, change, base, base, ...
until each has run ``--pairs`` times, so a drift of the host's speed
falls on both alike. Each run times ``--steps`` bare train steps after
20 warm ones (the flags of main.py go to both, e.g. the family's).
``--unroll`` goes to both as profile_train's (replays of a chunk of N
steps), ``--base-unroll`` to the base alone: ``paired_steps . .
--unroll 50 --base-unroll 1`` pairs the chunked steps of one tree with
its per-step ones. Prints
per checkout the median and quartiles of its train steps/s (1000 / the
unprofiled host ms per step) and of its device busy ms per step, with the
card's name and power limit, then one JSON line of every run. Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

from ..utils import runtime


def _run(root, steps, flags, out):
    cmd = [sys.executable, "-m",
           "controlled_peptide_generation_tpu_torch.tools.profile_train",
           "--steps", str(steps), "--warm", "20", "--out", out, *flags]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"profile_train failed in {root}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    with open(out) as fh:
        rep = json.load(fh)
    return {"steps_per_s": 1e3 / rep["wall_ms_per_step"],
            "busy_ms": rep["device_busy_ms_per_step"]}


def _quartiles(xs):
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return {"median": med, "q1": q1, "q3": q3}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--base-unroll", type=int, default=None)
    opts, flags = ap.parse_known_args(argv)
    unroll = {"base": opts.unroll if opts.base_unroll is None
              else opts.base_unroll, "change": opts.unroll}
    roots = {"base": os.path.abspath(opts.base),
             "change": os.path.abspath(opts.change)}
    runs = {"base": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(opts.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for name in order:
                out = os.path.join(tmp, f"{name}_{i}.json")
                # no flag at unroll 1: a checkout from before --unroll
                # profiles its per-step path
                extra = (["--unroll", str(unroll[name])] if unroll[name] > 1
                         else [])
                runs[name].append(_run(roots[name], opts.steps,
                                       flags + extra, out))
    card = runtime.card_line()
    report = {"card": card, "flags": flags, "steps": opts.steps,
              "unroll": unroll, "runs": runs}
    for name in ("base", "change"):
        sps = _quartiles([r["steps_per_s"] for r in runs[name]])
        busy = _quartiles([r["busy_ms"] for r in runs[name]])
        report[name] = {"root": roots[name], "steps_per_s": sps,
                        "busy_ms": busy}
        print(f"[paired] {name} ({roots[name]}; unroll {unroll[name]} "
              f"{' '.join(flags)}): "
              f"{sps['median']:.2f} steps/s (quartiles {sps['q1']:.2f}-"
              f"{sps['q3']:.2f}), device busy {busy['median']:.4f} ms a step "
              f"(quartiles {busy['q1']:.4f}-{busy['q3']:.4f}), "
              f"{opts.pairs} runs of {opts.steps} steps ({card})",
              flush=True)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
