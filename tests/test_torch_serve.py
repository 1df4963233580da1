"""The port's serving layer on the CPU: every case of tests/test_serve.py for
the port's GenerationServer and HTTP front end on a tiny run dir (a
JAX-saved checkpoint and states dumps), the first round held to one
``pipeline.launch_round`` outside the server, a cross-check against the
JAX package's GenerationServer fed the same raw rounds, a forced beam
canary trip, and the server's queue-wait histogram and spans (none
recorded while nothing asks for them; the worker's own parents). Every
generate() carries a timeout; every server is stopped in a finally."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from controlled_peptide_generation_tpu import config as JC
from controlled_peptide_generation_tpu import serve as JS
from controlled_peptide_generation_tpu.api import load_vocab as j_load_vocab

from controlled_peptide_generation_tpu_torch import config as TC
from controlled_peptide_generation_tpu_torch import pipeline
from controlled_peptide_generation_tpu_torch import serve as S
from controlled_peptide_generation_tpu_torch.api import load_vocab
from controlled_peptide_generation_tpu_torch.utils import tracing

from test_torch_pipeline import FLAGS, run_dir  # noqa: F401
from test_torch_serial import VOCAB

ITOS = load_vocab(VOCAB).itos
TIMEOUT = 120


def _serve_flags(top):
    flags = list(FLAGS)
    i = flags.index("--n_samples_acc")
    del flags[i:i + 2]
    return flags + ["--savepath_toplevel", top, "--n_samples_per_round",
                    "256", "--Q_n_components", "4"]


@pytest.fixture(scope="module")
def built(run_dir):  # noqa: F811
    cfg, args, _ = TC.parse_and_finalize(_serve_flags(run_dir),
                                         extra_args=S.EXTRA_ARGS)
    return cfg, S.build_server(cfg, args, device="cpu")


@pytest.fixture(scope="module")
def server(built):
    srv = built[1].start()
    try:
        yield srv
    finally:
        srv.stop()


def _http(srv):
    httpd = S.make_http_server(srv, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url + "/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_generate_unique_rows(server):
    rows = server.generate(4, timeout=TIMEOUT)
    assert len(rows) == 4
    peps = [r["peptide"] for r in rows]
    assert len(set(peps)) == 4
    for r in rows:
        assert {"peptide", "H", "uH", "charge",
                "clfZ_prob_accum"}.issubset(r)
        assert 0.0 <= r["clfZ_prob_accum"] <= 1.0
    rows2 = server.generate(4, timeout=TIMEOUT)
    assert not set(peps) & {r["peptide"] for r in rows2}


def test_concurrent_requests_coalesce(server):
    results = {}

    def ask(name):
        results[name] = server.generate(3, timeout=TIMEOUT)

    threads = [threading.Thread(target=ask, args=(f"c{i}",))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    all_peps = [r["peptide"] for rows in results.values() for r in rows]
    assert len(all_peps) == 9 and len(set(all_peps)) == 9
    stats = server.stats_snapshot()
    assert stats["served"] >= 9
    assert stats["accepted"] > 0 and stats["candidates"] > 0


def test_generate_timeout_and_validation(server):
    with pytest.raises(ValueError):
        server.generate(0, timeout=1)
    with pytest.raises(TimeoutError):
        server.generate(10_000, timeout=1e-6)
    assert server.generate(1, timeout=TIMEOUT)


def test_http_api(server):
    httpd, url = _http(server)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "backend": "cpu", "n_devices": 1}
        out = _post(url, json.dumps({"n": 2}).encode())
        assert out["n"] == 2 and len(out["samples"]) == 2
        assert all("peptide" in s for s in out["samples"])
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["rounds"] >= 1 and stats["unique_seen"] >= 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, json.dumps({"n": 0}).encode())
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def _bare(round_size=16, model=None, cls=S.GenerationServer, cfg=None):
    cfg = cfg or types.SimpleNamespace(seed=0, hw=TC.default_config().hw)
    # a stand-in GRU model inside the beam kernel's scope (the canary
    # checks only rounds that a kernel decodes)
    fake = types.SimpleNamespace(G_class="gru", gru_args={}, max_seq_len=25,
                                 n_vocab=24, h_dec=102)
    return cls(cfg=cfg, model=model or fake,
               params=None, vocab=None, Q=None, round_size=round_size,
               device="cpu")


def test_stop_fails_queued_requests():
    """stop() makes a blocked generate() raise, not return fewer than n
    rows; a generate() after stop() raises."""

    class _EmptyRounds(S.GenerationServer):
        def _launch_guarded(self, n):
            return n, time.perf_counter(), None

        def _finish_round(self, pending):
            time.sleep(0.05)
            return []

    srv = _bare(8, cls=_EmptyRounds).start()
    errs = {}

    def ask():
        try:
            srv.generate(5, timeout=30)
        except Exception as e:
            errs["e"] = e

    t = threading.Thread(target=ask)
    try:
        t.start()
        time.sleep(0.3)
    finally:
        srv.stop()
    t.join(10)
    assert isinstance(errs.get("e"), RuntimeError)
    with pytest.raises(RuntimeError):
        srv.generate(1, timeout=1)


def test_timeout_recycles_partial_rows(server):
    fake_rows = [{"peptide": f"__SPARE_{i}__", "H": 0.0, "uH": 0.0,
                  "charge": 0.0} for i in range(3)]
    with server._lock:
        server._spare.clear()
        server._spare.extend(fake_rows)
        rounds_before = server.stats["rounds"]
    rows = server.generate(3, timeout=TIMEOUT)
    assert [r["peptide"] for r in rows] == [r["peptide"] for r in fake_rows]
    assert server.stats["rounds"] == rounds_before


def test_http_client_errors_are_400(server):
    httpd, url = _http(server)
    try:
        for body in (b"{not json", json.dumps({"n": "abc"}).encode(),
                     json.dumps({"n": 1, "timeout": None}).encode(),
                     json.dumps([1, 2]).encode()):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, body)
            assert ei.value.code == 400, body
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_round_sizes_respects_transformer_lane_budget():
    cfg = types.SimpleNamespace(seed=0, hw=TC.default_config().hw)
    cfg.hw.tfm_lane_budget_gb = 0.05
    model = types.SimpleNamespace(
        G_class="transformer", max_seq_len=25,
        dec_tfm_args={"n_layers": 2, "d_model": 128})
    srv = _bare(5000, model=model, cfg=cfg)
    budget = pipeline.transformer_dispatch_budget(cfg, model)
    assert budget is not None and budget < 5000
    assert srv._round_size_bounded() <= max(budget, 1)
    assert _bare(5000, cfg=cfg)._round_size_bounded() == 5000


def test_fatal_worker_error_fails_queued_requests(monkeypatch):
    srv = _bare(16)

    def boom(*a, **k):
        raise RuntimeError("simulated execution-time device failure")

    monkeypatch.setattr(S.pipeline, "launch_round", boom)
    srv.start()
    try:
        with pytest.raises(RuntimeError, match="server stopped"):
            srv.generate(1, timeout=30)
        with pytest.raises(RuntimeError, match="not running"):
            srv.generate(1, timeout=1)
        assert "simulated execution-time" in srv.stats["fatal_error"]
    finally:
        srv.stop()


class _FakeVocab:
    itos = ITOS

    @staticmethod
    def to_sentences_batch(tokens, print_special_tokens=True):
        return ["PEP" + str(int(t[1])) for t in tokens]


def test_execution_oom_shrinks_round_and_recovers(monkeypatch):
    """An out-of-memory error when a round's event is waited on halves
    the round cap, and the queued request is still served."""
    srv = _bare(16)
    srv.vocab = _FakeVocab
    calls = {"n": 0}
    finishes = {"n": 0}

    class FakeOOM(Exception):
        pass

    class Event:
        # launch_round's device span: its timing events read as completed,
        # 1 ms apart; the first wait on it raises
        start = stop = types.SimpleNamespace(query=lambda: True,
                                             elapsed_time=lambda _: 1.0)

        def synchronize(self):
            finishes["n"] += 1
            if finishes["n"] == 1:
                raise FakeOOM("simulated")

    def fake_launch(cfg_, model_, params_, Q_, n, gen):
        calls["n"] += 1
        tok = np.full((4, 6), 4 + calls["n"] % 20, np.int64)
        tok[:, 0] = 2
        tok[:, -1] = 3
        accept = np.array([True, False, False, False])
        return (None, {}, accept, tok, None), Event()

    monkeypatch.setattr(S.pipeline, "launch_round", fake_launch)
    monkeypatch.setattr(S.pipeline, "is_device_oom",
                        lambda e: isinstance(e, FakeOOM))
    srv.start()
    try:
        rows = srv.generate(1, timeout=60)
        assert len(rows) == 1
        assert srv._max_candidates is not None and srv._max_candidates < 16
        assert calls["n"] >= 2
    finally:
        srv.stop()


def test_bounded_rounds_and_yield_estimates():
    srv = _bare(5000)
    rates = srv._rates_locked()
    assert srv._round_size_bounded() == 5000
    assert srv._depth == int(srv.cfg.hw.rounds_in_flight) + 1
    assert srv._expected_yield(1000, rates) == pytest.approx(1000 * 0.05)
    srv.stats.update(candidates=1000, accepted=400, duplicates=40)
    rates = srv._rates_locked()
    assert srv._expected_yield(1000, rates) == pytest.approx(
        1000 * 0.4 * 0.9)


def test_device_oom_is_the_cuda_allocator_error_only():
    assert pipeline.is_device_oom(torch.cuda.OutOfMemoryError("x"))
    assert not pipeline.is_device_oom(RuntimeError("CUDA out of memory"))
    assert not pipeline.is_device_oom(MemoryError())


def test_first_round_is_one_launch_round(built):
    """The first round's rows, in order and bit for bit, are the deduped
    accepted rows of one pipeline.launch_round with round_generator(seed,
    1) outside the server."""
    cfg, srv0 = built
    n = 64
    host, _ = pipeline.launch_round(cfg, srv0.model, srv0.shards, srv0.Q, n,
                                    pipeline.round_generator(cfg.seed, 1,
                                                             "cpu"))
    _, scores, accept, tokens, _ = host
    acc = accept.numpy()
    toks = tokens.numpy()[acc]
    seen, first = set(), []
    for i, k in enumerate(pipeline.canonical_keys(toks)):
        if k not in seen:
            seen.add(k)
            first.append(i)
    peps = load_vocab(VOCAB).to_sentences_batch(
        toks[first].astype(np.int64), print_special_tokens=False)
    want = [(p, {k: v.numpy()[acc][i] for k, v in scores.items()})
            for p, i in zip(peps, first)]
    assert len(want) > 5
    srv = S.GenerationServer(cfg, srv0.model, srv0.params, srv0.vocab,
                             srv0.Q, round_size=n, device="cpu").start()
    try:
        rows = srv.generate(len(want), timeout=TIMEOUT)
    finally:
        srv.stop()
    assert [r["peptide"] for r in rows] == [p for p, _ in want]
    for r, (_, sc) in zip(rows, want):
        for k, v in sc.items():
            assert np.float32(r[k]).tobytes() == v.tobytes()


def _raw_rounds(n_rounds, n, seed):
    """Raw rounds with duplicates within and across rounds."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rounds):
        tok = np.full((n, 8), 1, np.int64)
        tok[:, 0] = 2
        length = rng.integers(1, 4, n)
        for i in range(n):
            tok[i, 1:1 + length[i]] = rng.integers(4, 8, length[i])
            tok[i, 1 + length[i]] = 3
        scores = {k: rng.random(n).astype(np.float32)
                  for k in ("clfZ_prob_accum", "clfZ_amp=1", "clfZ_tox=0")}
        out.append((scores, rng.random(n) < 0.6, tok))
    return out


def _queue_then_start(srv, ns):
    """Queue the requests in order before the worker starts (so both
    servers see the same demand), then start it; returns the results."""
    srv._running = True
    results, threads = {}, []
    for i, n in enumerate(ns):
        def ask(i=i, n=n):
            results[i] = srv.generate(n, timeout=60)
        threads.append(threading.Thread(target=ask))
        threads[-1].start()
        deadline = time.time() + 30
        while len(srv._queue) < i + 1 and time.time() < deadline:
            time.sleep(0.001)
    srv._running = False
    srv.start()
    for t in threads:
        t.join(60)
    return [results.get(i) for i in range(len(ns))]


def _settle(srv, launches):
    deadline = time.time() + 30
    while srv.stats["rounds"] < launches["n"] and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)


def test_rows_and_stats_match_the_jax_server(monkeypatch):
    """The JAX package's GenerationServer and the port's, fed the same raw
    rounds and the same queued requests, hand the same rows to the same
    requests and end with the same counters."""
    rounds = _raw_rounds(12, 16, 3)
    ns = [5, 11, 3, 7]
    launches = {"jax": {"n": 0}, "torch": {"n": 0}}

    def jax_launch(cfg_, model_, params_, Q_, n, key, fused, mesh):
        i = launches["jax"]["n"]
        launches["jax"]["n"] += 1
        scores, accept, tok = rounds[i]
        return (None, dict(scores), accept, tok.astype(np.int32), None, None)

    def torch_launch(cfg_, model_, params_, Q_, n, gen):
        i = launches["torch"]["n"]
        launches["torch"]["n"] += 1
        scores, accept, tok = rounds[i]
        return (None, {k: torch.from_numpy(v) for k, v in scores.items()},
                torch.from_numpy(accept), torch.from_numpy(tok), None), None

    monkeypatch.setattr(JS.pipeline, "launch_round", jax_launch)
    monkeypatch.setattr(S.pipeline, "launch_round", torch_launch)
    jvocab = j_load_vocab(VOCAB)
    jsrv = JS.GenerationServer(
        cfg=types.SimpleNamespace(seed=0, hw=JC.default_config().hw),
        model=types.SimpleNamespace(G_class="gru"), params=None,
        dataset=types.SimpleNamespace(
            idx2sentences=jvocab.to_sentences_batch, vocab=jvocab),
        Q=None, round_size=16)
    tsrv = _bare(16)
    tsrv.vocab = load_vocab(VOCAB)
    try:
        want = _queue_then_start(jsrv, ns)
        _settle(jsrv, launches["jax"])
        got = _queue_then_start(tsrv, ns)
        _settle(tsrv, launches["torch"])
    finally:
        jsrv.stop()
        tsrv.stop()
    assert [len(r) for r in got] == ns
    assert got == want
    keys = ("rounds", "candidates", "accepted", "served", "duplicates",
            "outstanding", "unique_seen")
    js, ts = jsrv.stats_snapshot(), tsrv.stats_snapshot()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert launches["torch"] == launches["jax"]
    assert ts["duplicates"] > 0 and list(tsrv._spare) == list(jsrv._spare)


def test_canary_trip_fails_queued_requests(monkeypatch):
    """A round whose decodes collapse to one sequence on the card's route
    (the check reads only the device, so it is forced to "cuda" here)
    raises BeamCanaryError in the worker: every queued request fails,
    HTTP answers 503, and /stats names the fatal error."""
    real = pipeline.beam_canary_check
    monkeypatch.setattr(
        S.pipeline, "beam_canary_check",
        lambda cfg, device, *a, **k: real(cfg, "cuda", *a, **k))

    def collapsed(cfg_, model_, params_, Q_, n, gen):
        tok = np.full((n, 6), 5, np.int64)
        tok[:, 0], tok[:, -1] = 2, 3
        return (None, {}, np.ones(n, bool), tok, None), None

    monkeypatch.setattr(S.pipeline, "launch_round", collapsed)
    srv = _bare(512)
    srv.vocab = _FakeVocab
    httpd, url = _http(srv)
    try:
        srv._running = True
        errs = {}

        def ask():
            try:
                srv.generate(600, timeout=60)
            except Exception as e:
                errs["e"] = e

        t = threading.Thread(target=ask)
        t.start()
        while not srv._queue:
            time.sleep(0.001)
        srv._running = False
        srv.start()
        t.join(60)
        assert isinstance(errs.get("e"), RuntimeError)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, json.dumps({"n": 1}).encode())
        assert ei.value.code == 503
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["fatal_error"].startswith("BeamCanaryError")
        assert srv.stats["rounds"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def _waits(snap):
    return sum(snap["queue_wait"]["counts"])


def test_queue_wait_counts_every_request(server):
    """Each request served adds one wait (generate() to its first row). No
    span is recorded, and on the CPU no round has device time."""
    tracing.clear()
    before = server.stats_snapshot()
    done = []

    def ask():
        done.append(len(server.generate(2, timeout=TIMEOUT)))

    threads = [threading.Thread(target=ask) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert done == [2, 2, 2]
    assert len(server.generate(1, timeout=TIMEOUT)) == 1
    after = server.stats_snapshot()
    assert _waits(after) - _waits(before) == 4
    assert after["queue_wait"]["counts"][-1] == before["queue_wait"][
        "counts"][-1]
    assert tracing.spans() == []
    assert after["device_s"] == after["device_gap_s"] == 0.0
    assert set(after["stage_s"]) == {"d2h", "host_postproc"}
    json.dumps(after)


def test_queue_wait_overflow_counts_failed_requests():
    """A request that times out, or that stop() fails, before its first
    row counts in the overflow bucket, whose share reads as an infinite
    percentile."""

    class _EmptyRounds(S.GenerationServer):
        def _launch_guarded(self, n):
            return n, time.perf_counter(), None

        def _finish_round(self, pending):
            time.sleep(0.02)
            return []

    srv = _bare(8, cls=_EmptyRounds).start()
    errs = []

    def ask():
        try:
            srv.generate(3, timeout=30)
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=ask)
    try:
        with pytest.raises(TimeoutError):
            srv.generate(2, timeout=0.05)
        t.start()
        time.sleep(0.2)
    finally:
        srv.stop()
    t.join(10)
    assert not t.is_alive() and len(errs) == 1
    snap = srv.stats_snapshot()["queue_wait"]
    assert sum(snap["counts"]) == snap["counts"][-1] == 2
    assert tracing.Histogram.percentile(snap, 95) == float("inf")


def test_worker_spans_have_the_workers_parents(server):
    """Spans forced on around a client's request: the worker thread's
    round spans (launch, postproc, distribute) carry its own parents,
    never the client's span open on another thread."""
    with server._lock:
        server._spare.clear()
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("client") as client:
            server.generate(3, timeout=TIMEOUT)
            server.generate(3, timeout=TIMEOUT)
    finally:
        tracing.enable(False)
    worker = server._worker.ident
    spans = [s for s in tracing.spans() if s.name.startswith("serve.")]
    names = {s.name for s in spans}
    assert {"serve.round.launch", "serve.postproc",
            "serve.distribute"} <= names
    assert "serve.round.wait" not in names      # no device span on the CPU
    for s in spans:
        assert s.thread == worker and s.parent is None, s
    assert tracing.spans("client")[0].thread != worker
    launched = {s.ids["round"] for s in tracing.spans("serve.round.launch")}
    assert launched & {s.ids["round"] for s in
                       tracing.spans("serve.postproc")}
    assert client.parent is None
