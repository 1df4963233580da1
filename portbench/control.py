"""Readings for the correctness limits: the compared numbers of a cell's
program (sound runs), of its control (the program in the precision below
the configuration's: the cell file's ``control_flags`` and the reference
in bfloat16 in the program's place for serving, TF32 products for
training) or of the program with a fault planted underneath, over many
seeds in one process, with a short window each.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--control 1] [--fault token|half_batch|unchanged]

Prints one JSON line a seed: {"seed", "control", "fault", "numbers",
"e2e"}.
"""

import argparse
import importlib
import json
import sys
import time


def plant(fault):
    """Break the timed path underneath; returns the function that mends it.
    ``token``: the first residue of every decoded row altered where the
    round produces it; ``half_batch``: each step's loss over the first half
    of its batch; ``unchanged``: Adam's step leaves the state as it was."""
    import torch
    if fault == "token":
        from controlled_peptide_generation_tpu_torch import pipeline as mod
        name, orig = "launch_round", mod.launch_round

        def broken(*a, **k):
            (z, scores, accept, tokens, valid), event = orig(*a, **k)
            if event is not None:
                event.synchronize()
            tokens = tokens.clone()
            tokens[:, 1] = 4 + (tokens[:, 1].long() - 3) % 20
            return (z, scores, accept, tokens, valid), event
    elif fault == "half_batch":
        from controlled_peptide_generation_tpu_torch.train import (
            train_vae as mod)
        name, orig = "make_loss_fn", mod.make_loss_fn

        def broken(*a, **k):
            loss_fn = orig(*a, **k)

            def half(params, text, beta, draws):
                n = text.shape[0]
                cut = {key: (v[:n // 2] if torch.is_tensor(v) and v.dim()
                             and v.shape[0] == n else v)
                       for key, v in draws.items()}
                return loss_fn(params, text[:n // 2], beta, cut)
            return half
    elif fault == "unchanged":
        from controlled_peptide_generation_tpu_torch.train import opt
        mod, name, orig = opt.ClipAdam, "step", opt.ClipAdam.step

        def broken(self, params, grads, state):
            return opt.ClipAdam.global_norm(grads)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(mod, name, broken)
    return lambda: setattr(mod, name, orig)


def readings(name, seeds, seconds, control, device=None, edit=None):
    """[(seed, numbers, e2e)] of cell ``name``; ``edit(config, traffic)``
    may change the files' contents first (tests shrink them)."""
    from portbench import harness
    from portbench.run import Run, _caches
    entry, cell, config, traffic = harness.cell_files(name)
    if edit is not None:
        config, traffic = edit(dict(config), dict(traffic))
    _caches()
    import torch
    if device is None:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.init()
    driver = importlib.import_module("portbench.drivers." + traffic["driver"])
    out = []
    for seed in seeds:
        run = Run(name, entry, cell, config, traffic, seed, seconds, 0,
                  time.perf_counter())
        res = driver.run(run, device, control=control)
        out.append((seed, res["numbers"], res["e2e"]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control measures the card: no CUDA device",
              file=sys.stderr)
        return 2
    mend = plant(args.fault) if args.fault else None
    try:
        for seed, numbers, e2e in readings(
                args.workload, [int(s) for s in args.seeds.split(",")],
                args.seconds, bool(args.control)):
            print(json.dumps({"seed": seed, "control": args.control,
                              "fault": args.fault, "numbers": numbers,
                              "e2e": e2e}), flush=True)
    finally:
        if mend is not None:
            mend()
    return 0


if __name__ == "__main__":
    sys.exit(main())
