"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (building the program's kernels, making the weights and data from
the seed, warming up every shape the cell uses) counts in ``setup_s``;
then the cell's driver measures for ``--seconds`` seconds, frees the
program's state and holds what the timed path produced against the plain
reference. The last line of standard output is one JSON object (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics from a
bounded profiler window with ``--trace 1``); the last lines of standard
error give each compared number beside its limit. Without as many CUDA
devices as the cell asks for, or with JAX or the JAX package loaded once
the window has closed, the run prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


class Run:
    """One run's cell, files and arguments, handed to the cell's driver."""

    def __init__(self, name, entry, cell, config, traffic, seed, seconds,
                 trace, t_start):
        self.name, self.entry, self.cell = name, entry, cell
        self.config, self.traffic = config, traffic
        self.seed = int(seed) % 2 ** 63
        self.seconds, self.trace, self.t_start = float(seconds), bool(trace), t_start

    def log(self, msg):
        print(f"[portbench {time.perf_counter() - self.t_start:8.2f}s] {msg}",
              file=sys.stderr, flush=True)


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc and gcc builds are under build/ already)."""
    from portbench import harness
    build = os.path.join(harness.ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def execute(run, device):
    """Drive the cell on ``device``; returns (exit code, result line or
    None). The caller has checked the devices."""
    from portbench import harness
    driver = importlib.import_module("portbench.drivers." + run.traffic["driver"])
    res = driver.run(run, device)
    correct, checks = harness.judge(res["numbers"], run.cell["limits"])
    correct = correct and res["failed"] == 0
    bench = harness.benchmark()
    if run.trace:
        metrics = harness.read_per_layer(run.name, res["ctx"], bench)
    else:
        units = {m["name"]: m["unit"]
                 for m in harness.metrics_for(run.name, "end_to_end", bench)}
        metrics = {k: {"value": float(res["e2e"][k]), "unit": u}
                   for k, u in units.items()}
    found = harness.forbidden_modules()
    if found:
        run.log(f"refusing to report: loaded {found}")
        return 3, None
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    return 0, harness.result_line(correct, res["attempted"], res["failed"],
                                  metrics, res["device"], checks,
                                  res.get("breakdown") if run.trace else None)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import harness
    entry, cell, config, traffic = harness.cell_files(args.workload)
    _caches()
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(args.workload, entry, cell, config, traffic, args.seed,
              args.seconds, args.trace, T_START)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    code, line = execute(run, device)
    if line is not None:
        print(line, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
