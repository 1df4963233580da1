"""The port's spans and counters (``utils/tracing.py``) on the CPU: the
histogram's percentiles against numpy's, a span against the
``record_function`` range it opens under a CPU profiler (the shared
clock), parent ids by thread, the shared no-op when nothing records, the
counters, and the bounded ``trace`` window. Runs on one torch thread."""

import glob
import json
import math
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from controlled_peptide_generation_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()
    torch.set_num_threads(n)


@pytest.mark.parametrize("q", [50, 95, 99])
@pytest.mark.parametrize("base", [False, True])
def test_histogram_percentile_within_one_bucket_of_numpy(q, base):
    """Waits of 20 us to some seconds (log-normal); with ``base`` the
    percentile of the values added after an earlier snapshot."""
    rng = np.random.default_rng(q)
    first = np.exp(rng.normal(-4.0, 1.5, 500))
    waits = np.exp(rng.normal(-3.0, 1.0, 3000))
    h = tracing.Histogram()
    for x in first:
        h.add(float(x))
    before = h.snapshot()
    for x in waits:
        h.add(float(x))
    if base:
        got = tracing.Histogram.percentile(h.snapshot(), q, before)
        ref = np.percentile(waits, q)
    else:
        got = tracing.Histogram.percentile(h.snapshot(), q)
        ref = np.percentile(np.concatenate([first, waits]), q)
    assert abs(got - ref) <= (h.growth - 1.0) * ref


def test_histogram_edges_and_overflow():
    h = tracing.Histogram()
    assert tracing.Histogram.percentile(h.snapshot(), 95) is None
    h.add(0.0)
    h.add(5e6)                      # past hi: the overflow bucket
    assert h.counts[0] == 1 and h.counts[-1] == 1
    for _ in range(18):
        h.add(1.0)
    snap = h.snapshot()
    assert sum(snap["counts"]) == 20
    assert abs(tracing.Histogram.percentile(snap, 90) - 1.0) <= 0.05
    h.add_overflow()
    h.add_overflow()
    assert tracing.Histogram.percentile(h.snapshot(), 95) == math.inf
    assert json.loads(json.dumps(h.snapshot())) == h.snapshot()


def test_span_lies_within_its_record_function_range():
    """Under a CPU profiler each span opens a record_function range of its
    name; the span's ends lie within 50 us of the range's, on the
    profiler's clock (Unix-epoch nanoseconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(30):
            with tracing.span(f"clock{i}", i=i):
                time.sleep(2e-4)
    spans = {s.name: s for s in tracing.spans()}
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in spans}
    assert set(ranges) == set(spans)
    for name, s in list(spans.items())[5:]:   # past the first calls' set-up
        e = ranges[name]
        assert abs(s.start_ns - e.start_ns()) <= 50_000, name
        assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) <= 50_000
    assert spans["clock7"].ids == {"i": 7}
    assert abs(spans["clock0"].start_ns - time.time_ns()) < 60e9


def test_parents_follow_nesting_on_each_thread():
    tracing.enable()
    seen = {}

    def other():
        with tracing.span("other") as s:
            seen["other"] = threading.get_ident()

    with tracing.span("outer") as outer:
        with tracing.span("inner", it=3) as inner:
            t = threading.Thread(target=other)
            t.start()
            t.join(10)
        with tracing.span("second"):
            pass
    assert not t.is_alive()
    by = {s.name: s for s in tracing.spans()}
    assert by["outer"].parent is None and by["outer"].id == outer.id
    assert by["inner"].parent == outer.id and by["inner"].id == inner.id
    assert by["second"].parent == outer.id
    assert by["other"].parent is None
    assert by["other"].thread == seen["other"] != by["outer"].thread
    assert by["inner"].ids == {"it": 3}
    assert [s.name for s in tracing.spans()][-1] == "outer"


def test_no_recording_is_one_shared_noop_and_counters_count():
    assert tracing.span("a") is tracing.span("b")
    c = tracing.counter("test.tracing.counter")
    n0 = c.count
    with tracing.span("a"):
        pass
    with tracing.span("timed", c, it=1):
        time.sleep(1e-3)
    assert tracing.spans() == []
    snap = tracing.snapshot()["test.tracing.counter"]
    assert snap["count"] == n0 + 1 and snap["sum"] >= 1e-3
    assert tracing.counter("test.tracing.counter") is c
    tracing.enable()
    with tracing.span("timed", c):
        pass
    assert c.count == n0 + 2 and len(tracing.spans("timed")) == 1
    assert tracing.device_span("cpu") is None


def test_bounded_profile_window(tmp_path):
    """``trace`` records the loop's boundaries 3-4 and no others: each
    boundary's span lands in the trace as a range inside its step; a loop
    that ends inside the window writes what it recorded (its last step
    runs to the block's end); no directory writes nothing and records no
    span."""
    with tracing.trace(str(tmp_path / "t")) as step:
        for i in range(9):
            with tracing.span("loop", it=i):
                torch.ones(3).sum()
            step()
    with tracing.trace(str(tmp_path / "short")) as step:
        for i in range(4):
            with tracing.span("loop", it=i):
                torch.ones(3).sum()
            step()
    recorded = [s.ids["it"] for s in tracing.spans("loop")]
    assert recorded == [3, 4, 3]
    tracing.clear()
    with tracing.trace("") as step:
        with tracing.span("loop"):
            step()
    assert tracing.spans() == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["short", "t"]
    for d, loops in (("t", 2), ("short", 1)):
        files = glob.glob(str(tmp_path / d / "*.pt.trace.json"))
        assert len(files) == 1, files
        with open(files[0]) as fh:
            events = json.load(fh)["traceEvents"]
        names = [e.get("name", "") for e in events]
        assert {n for n in names if n.startswith("ProfilerStep#")} == {
            f"ProfilerStep#{i}" for i in (3, 4)}
        assert names.count("loop") == loops
