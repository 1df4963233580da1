"""The readers of the program's spans and counters on the CPU: each on a
synthetic ``ctx`` as the drivers build it (and on one a program without
those counters builds: nothing to read), and tiny traced runs of a serve
and a train cell reporting the readings a CPU run has (the queue wait,
the loader's and the boundary's host time) and none of the device's."""

import math

import pytest

from controlled_peptide_generation_tpu_torch.utils import tracing
from portbench import harness
from portbench.trace import Window
from test_portbench_harness import _execute, _tmp, tiny_run  # noqa: F401


def _stats(rounds, device_s=None, gap_s=None, waits=()):
    out = {"rounds": rounds, "device_s": device_s or 0.0}
    if gap_s is not None:
        out["device_gap_s"] = gap_s
    h = tracing.Histogram()
    for w in waits:
        h.add(w)
    out["queue_wait"] = h.snapshot()
    return out


def test_queue_wait_p95_reads_the_windows_requests():
    read = harness.load_reader("serve.queue_wait_ms.p95")
    early = [5.0] * 50
    window = [0.01 * (i + 1) for i in range(100)]
    before, after = _stats(1, waits=early), _stats(2, waits=early + window)
    p = read({"before": before, "after": after})
    assert p == pytest.approx(1e3 * tracing.Histogram.percentile(
        after["queue_wait"], 95, before["queue_wait"]))
    assert abs(p - 950.5) <= 0.05 * 950.5     # numpy's p95 of the window
    del before["queue_wait"], after["queue_wait"]
    assert read({"before": before, "after": after}) is None
    failed = tracing.Histogram()
    failed.add_overflow()
    snap = failed.snapshot()
    assert read({"before": _stats(0), "after": {"queue_wait": snap}}) is None


def test_round_device_and_gap_ms():
    dev = harness.load_reader("round.device_ms")
    gap = harness.load_reader("serve.device_gap_ms")
    ctx = {"before": _stats(10, 1.0, 0.1), "after": _stats(30, 1.4, 0.14)}
    assert dev(ctx) == pytest.approx(20.0)
    assert gap(ctx) == pytest.approx(2.0)
    # the CPU: no event pairs, nothing timed
    cpu = {"before": _stats(10, 0.0, 0.0), "after": _stats(30, 0.0, 0.0)}
    assert dev(cpu) is None and gap(cpu) is None
    # a server whose device_s is host time (no device_gap_s beside it)
    host = {"before": _stats(10, 1.0), "after": _stats(30, 1.4)}
    assert dev(host) is None and gap(host) is None


def _window():
    w = Window()
    w.kernels = [("k1", 0.0, 4e5), ("k2", 5e5, 6e5)]
    w.host = [("Buffer Flush", 4.2e5, 4.4e5), ("aten::mm", 0.0, 1e5)]
    w.window_s, w.t0_us, w.t1_us = 1.0, 0.0, 1e6
    return w


def test_postproc_idle_share(monkeypatch):
    """Idle 0.4-0.5 s and 0.6-1.0 s; the worker's postproc 0.40-0.46 s and
    0.95-1.05 s; the profiler's flush 0.42-0.44 s: 0.04 + 0.05 s of 0.98 s
    the profiler did not hold."""
    read = harness.load_reader("idle_share.class.postproc")
    spans = [tracing.Span("serve.postproc", int(s * 1e9), int(e * 1e9), i,
                          None, 1, {"round": i})
             for i, (s, e) in enumerate([(0.40, 0.46), (0.95, 1.05)])]
    monkeypatch.setattr(tracing, "spans", lambda name=None: [
        s for s in spans if name is None or s.name == name])
    w = _window()
    got = read({"traced": {"window": w}})
    assert got == pytest.approx(100.0 * 0.09 / 0.98)
    assert got <= w.idle_share()
    w.kernels = []
    assert read({"traced": {"window": w}}) is None
    assert read({"traced": {}}) is None
    monkeypatch.setattr(tracing, "spans", lambda name=None: [])
    assert read({"traced": {"window": _window()}}) is None


def test_train_host_readers(monkeypatch):
    loader = harness.load_reader("train.loader_ms")
    boundary = harness.load_reader("train.boundary_ms")
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "train.loader": {"count": 40, "sum": 0.02},
        "train.boundary": {"count": 40, "sum": 0.4}})
    assert loader({}) == pytest.approx(0.5)
    assert boundary({}) == pytest.approx(10.0)
    monkeypatch.setattr(tracing, "snapshot", lambda: {})
    assert loader({}) is None and boundary({}) is None


def test_train_device_readers():
    dev = harness.load_reader("train.device_ms")
    gap = harness.load_reader("train.device_gap_ms")
    graph = {"capture_s": 1.0, "replays": 30, "device_s": 2.25,
             "timed": 30, "device_gap_s": 0.0725, "gaps": 29}
    assert dev({"graph": graph}) == pytest.approx(75.0)
    assert gap({"graph": graph}) == pytest.approx(2.5)
    for g in ({}, {"capture_s": 1.0, "instantiate_s": 0.5},
              dict(graph, timed=0, gaps=0)):
        assert dev({"graph": g}) is None and gap({"graph": g}) is None


@pytest.mark.parametrize("name, seconds, host, device", [
    ("tfm_wae.class_serve", 8.0, {"serve.queue_wait_ms.p95"},
     {"round.device_ms", "serve.device_gap_ms", "idle_share.class.postproc"}),
    ("gru_wae.train_p1", 4.0, {"train.loader_ms", "train.boundary_ms"},
     {"train.device_ms", "train.device_gap_ms"})])
def test_tiny_traced_run_reports_the_host_readings(name, seconds, host,
                                                   device):
    out = _execute(tiny_run(name, trace=1, seconds=seconds))
    assert out["correct"] is True, out["checks"]
    assert host <= set(out["metrics"])
    assert not device & set(out["metrics"])
    assert all(math.isfinite(out["metrics"][k]["value"])
               and out["metrics"][k]["value"] > 0 for k in host)
