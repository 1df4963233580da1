"""The harness on the CPU: discovery of cells and metrics by name, the
result line, the window and percentile arithmetic, the trace's busy and
idle time, names and units, the module check, the refusal without a card,
and whole runs of each driver at tiny sizes, sound and with the timed
path broken underneath (``correct`` must come out false)."""

import json
import os
import shutil
import time

import pytest
import torch

from portbench import control, harness, run as run_mod
from portbench.drivers import serve as serve_drv
from portbench.trace import Window, busy_spans, union_us

torch.set_num_threads(2)


def tiny(config, traffic):
    """A cell's files shrunk to a size the CPU runs in seconds."""
    config = dict(config)
    if config["family"] == "transformer":
        config.update(z_dim=8, emb_dim=12, d_model=16, d_ff=32, n_heads=2,
                      rf_dim=16, max_seq_len=10)
    else:
        config.update(z_dim=8, emb_dim=12, enc_h_dim=6, rf_dim=16,
                      max_seq_len=10)
    traffic = dict(traffic)
    if traffic["driver"] == "serve":
        traffic.update(clients=3, n_min=4, n_max=16, sizes_per_client=4,
                       round_size=60, warmup_rounds=2, corpus_rows=300,
                       q_components=5, q_samples=2, check_rows=16)
    else:
        traffic.update(corpus={"n_unlab": 300, "n_amp": 40, "n_tox": 40,
                               "seed": 7734, "min_len": 3, "max_len": 8,
                               "structured": True}, warmup_chunks=1)
        traffic["flags"] = list(traffic["flags"]) + [
            "--hw.unroll", "5", "--vae.cheaplog_every", "10",
            "--vae.expsvlog_every", "20"]
    return config, traffic


def tiny_run(name, seed=12345678901, seconds=1.0, trace=0):
    entry, cell, config, traffic = harness.cell_files(name)
    config, traffic = tiny(config, traffic)
    return run_mod.Run(name, entry, cell, config, traffic, seed, seconds,
                       trace, time.perf_counter())


@pytest.fixture(autouse=True)
def _tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# ---- the files --------------------------------------------------------------


def test_every_name_unit_and_file():
    bench = harness.benchmark()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[key]:
            assert harness.valid_name(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.valid_unit(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        entry, cell, config, traffic = harness.cell_files(w["name"])
        reported = [m["name"] for m in harness.metrics_for(
            w["name"], "end_to_end", bench)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_for(w["name"], "per_layer", bench)
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in reported, (w["name"], m["name"])
        assert set(cell["limits"]) and config["n_vocab"] == len(config["itos"])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e


def test_discovery_of_a_new_cell_and_metric(tmp_path, monkeypatch):
    """A cell and a metric added as files and entries, no edit elsewhere."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    bench["workloads"].append({"name": "gru_wae.class_serve",
                               "config": "gru_wae", "traffic": "class_serve",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("gru_wae.class_serve")
    bench["per_layer"].append({"name": "test.rounds", "unit": "rounds",
                               "better": "higher", "source": "program_counter",
                               "layer": "serve", "moves": "accepted_per_s",
                               "workloads": ["gru_wae.class_serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "portbench/cells/tfm_wae.class_serve.json",
                root / "portbench/cells/gru_wae.class_serve.json")
    (root / "portbench/metrics/test.rounds.py").write_text(
        "def read(ctx):\n    return ctx['after']['rounds']\n")
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "portbench"))
    entry, cell, config, traffic = harness.cell_files("gru_wae.class_serve")
    assert config["family"] == "gru" and traffic["driver"] == "serve"
    names = [m["name"] for m in harness.metrics_for("gru_wae.class_serve",
                                                    "per_layer")]
    assert names == ["test.rounds"]
    got = harness.read_per_layer("gru_wae.class_serve",
                                 {"after": {"rounds": 7}})
    assert got == {"test.rounds": {"value": 7.0, "unit": "rounds"}}


def test_result_line_keys():
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5,
                                                          "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 3},
                               [["score_gap", 0.0, 1e-4]],
                               {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["score_gap"] == {"value": 0.0, "limit": 1e-4}


def test_judge():
    ok, rows = harness.judge({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 1.0})
    assert not ok and rows == [["a", 0.5, 1.0], ["b", 2.0, 1.0]]
    assert not harness.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not harness.judge({}, {"a": 1.0})[0]
    assert harness.judge({"a": 0}, {"a": 0})[0]


def test_names_and_units_restricted():
    assert harness.valid_name("request_ms.p95")
    assert harness.valid_name("b3.roofline")
    for bad in ("a b", "a,b", "a/b", "", "x" * 65, ".lead", "µs"):
        assert not harness.valid_name(bad)
    assert harness.valid_unit("tokens/s") and harness.valid_unit("%")
    for bad in ("tokens per second", "µs", "x" * 17, ""):
        assert not harness.valid_unit(bad)


def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        {"controlled_peptide_generation_tpu_torch": 1,
         "controlled_peptide_generation_tpu_torch.ops": 1,
         "jaxtyping": 1, "flaxen": 1}) == []
    assert harness.forbidden_modules(
        {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
         "controlled_peptide_generation_tpu.ops.beam": 1}) == [
        "controlled_peptide_generation_tpu.ops.beam", "flax", "jax",
        "jax.numpy", "jaxlib.xla"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run_mod.main(["--workload", "tfm_wae.class_serve", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "CUDA" in out.err


# ---- arithmetic ----------------------------------------------------------


def test_percentile_is_numpy_linear():
    import numpy as np
    xs = [float(x) for x in np.random.default_rng(0).exponential(size=997)]
    for q in (50, 95, 99):
        assert harness.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert harness.percentile([3.0], 95) == 3.0


def test_request_sizes_one_multiset_for_every_seed():
    mix = harness.load_json(harness.HERE, "traffic", "class_serve.json")
    a = serve_drv.request_sizes(mix, 1)
    b = serve_drv.request_sizes(mix, 2 ** 31 + 5)
    assert sorted(x for c in a for x in c) == sorted(x for c in b for x in c)
    assert a != b and len(a) == mix["clients"]
    flat = [x for c in a for x in c]
    assert min(flat) >= mix["n_min"] and max(flat) <= mix["n_max"]
    assert 300 < sum(flat) / len(flat) < 400     # log-uniform mean 346


class _FakeServer:
    """generate(n) takes n ms and returns n rows."""

    def __init__(self):
        self.stats = {"rounds": 0}

    def generate(self, n, timeout=None):
        time.sleep(n / 1000.0)
        self.stats["rounds"] += 1
        return [{"peptide": "A"}] * n


def test_clients_window_counts_every_request():
    clients = serve_drv.Clients(_FakeServer(), [[5, 10], [20]], 5.0)
    deadline = time.perf_counter() + 0.2
    t0, records = clients.run(lambda: time.perf_counter() >= deadline)
    assert all(r[0] >= t0 - 1e-3 and r[1] > r[0] for r in records)
    assert all(r[0] < deadline for r in records)
    assert sum(len(r[3]) for r in records) == sum(r[2] for r in records)
    # each client keeps its place in its sizes
    assert clients.pos[1] == sum(1 for r in records if r[2] == 20)


def test_trace_union_and_idle_share():
    assert union_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert busy_spans([(20, 30), (0, 10), (5, 15)]) == [[0, 15], [20, 30]]
    w = Window()
    w.kernels = [("k1", 0.0, 4e5), ("k2", 2e5, 6e5), ("copy", 8e5, 9e5)]
    w.host = [("outer", 0.0, 1e6), ("aten::inner", 6.5e5, 7.5e5)]
    w.window_s, w.t0_us, w.t1_us = 1.0, 0.0, 1e6
    assert w.busy_s() == pytest.approx(0.7)
    read = harness.load_reader("idle_share.class")
    assert read({"traced": {"window": w}}) == pytest.approx(30.0)
    b = w.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.4)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps["aten::inner"] == pytest.approx(0.2)
    assert gaps["outer"] == pytest.approx(0.1)
    assert w.kernel_time("k") == (2, pytest.approx(0.8))


def test_idle_share_leaves_out_the_profilers_own_work():
    """Idle time in which the profiler flushed its buffers is the
    profiler's: it leaves both the idle time and the window."""
    w = Window()
    w.kernels = [("k1", 0.0, 4e5), ("k2", 5e5, 6e5)]
    w.host = [("Buffer Flush", 3e5, 4.5e5), ("cudaGraphLaunch", 6e5, 1e6),
              ("Activity Buffer Request", 9e5, 1.2e6)]
    w.window_s, w.t0_us, w.t1_us = 1.0, 0.0, 1e6
    assert [tuple(g) for g in w.idle_gaps()] == [(4e5, 5e5), (6e5, 1e6)]
    assert w.profiler_idle_s() == pytest.approx(0.15)
    assert w.idle_share() == pytest.approx(100.0 * 0.35 / 0.85)
    read = harness.load_reader("idle_share.train")
    assert read({"traced": {"window": w}}) == pytest.approx(w.idle_share())


# ---- whole runs on the CPU --------------------------------------------------


def _execute(run):
    code, line = run_mod.execute(run, torch.device("cpu"))
    assert code == 0
    return json.loads(line)


@pytest.mark.parametrize("name", ["tfm_wae.class_serve", "gru_wae.train_p1",
                                  "tfm_wae.train_p1"])
def test_sound_run_is_correct(name):
    out = _execute(tiny_run(name))
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    units = {m["name"] for m in harness.metrics_for(name, "end_to_end")}
    assert set(out["metrics"]) == units
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name, seconds, expect", [
    ("tfm_wae.class_serve", 8.0,
     {"serve.unique_share", "round.accept_rate", "round.decoded_per_s",
      "serve.host_ms_per_round"}),
    ("gru_wae.train_p1", 4.0, {"mfu.train", "idle_share.train"})])
def test_traced_run_reports_per_layer(name, seconds, expect):
    out = _execute(tiny_run(name, trace=1, seconds=seconds))
    assert expect <= set(out["metrics"])
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault, name, number", [
    ("token", "tfm_wae.class_serve", "decode_mismatch"),
    ("unchanged", "gru_wae.train_p1", "change_gap"),
    ("half_batch", "tfm_wae.train_p1", "loss_gap")])
def test_planted_fault_fails(fault, name, number):
    """The timed path broken underneath: a token altered where it is
    produced, a step that leaves its state unchanged, half of the batch
    left out; ``correct`` comes out false, on the number that should catch
    it."""
    mend = control.plant(fault)
    try:
        out = _execute(tiny_run(name))
    finally:
        mend()
    assert out["correct"] is False
    check = out["checks"][number]
    assert check["value"] > check["limit"]


def test_control_readings_at_tiny_size():
    """The class cell's control reads each row number off the reference
    put in the program's place in bfloat16, and the decode in bfloat16."""
    (seed, numbers, _), = control.readings(
        "tfm_wae.class_serve", [5], 1.0, True, torch.device("cpu"), tiny)
    assert numbers["score_gap"] > 1e-4
    assert numbers["physchem_gap"] > 1e-4
