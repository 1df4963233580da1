"""What every cell's run shares: finding a cell's files by name, the
per-layer readers, the correctness limits, the module check and the
result line."""

import importlib.util
import json
import math
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")

# top-level modules no run may hold: JAX and the JAX package (the port's
# name starts with the JAX package's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "controlled_peptide_generation_tpu")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(name):
    """(the cell's BENCHMARK.json entry, its cell file, its configuration
    file, its traffic file), each found by name."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(HERE, "cells", name + ".json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT, cfg_entry["file"])
    traffic = load_json(HERE, "traffic", entry["traffic"] + ".json")
    return entry, cell, config, traffic


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def valid_name(s):
    return bool(NAME_RE.match(s))


def valid_unit(s):
    return bool(UNIT_RE.match(s))


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics, as numpy's default."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def metrics_for(cell_name, kind, bench=None):
    """The entries of ``kind`` ("end_to_end" or "per_layer") that cell
    ``cell_name`` reports: those that list it, and those with no list
    whose end-to-end metric the cell reports."""
    bench = benchmark() if bench is None else bench
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if cell_name in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_reader(name):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell_name, ctx, bench=None):
    """{name: {"value", "unit"}} of the per-layer metrics this cell reports
    whose reader finds something to read."""
    out = {}
    for m in metrics_for(cell_name, "per_layer", bench):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers, limits):
    """(correct, [[name, value, limit]]): every compared number at or
    below its limit (each is a gap or a count: larger is worse). A number
    that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The last line of a run's standard output; the compared numbers come
    last, each beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return json.dumps(out)
