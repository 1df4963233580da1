"""Serving layer of the port: a long-lived service over the CLaSS rounds.

One process owns the trained model, the fitted Q(z|a) and the latent
attribute heads, and answers "give me n accepted peptides" requests from
many concurrent clients:

* One worker thread owns the card. It is the only thread that launches
  device work (torch's current stream is per thread; the beams read it in
  the thread that calls them), so concurrency becomes demand, not
  parallel device work.
* Demand coalescing: all outstanding requests share one stream of unique
  accepted rows, handed out FIFO. Every round is at most one round_size
  of candidates; a backlog is covered by more rounds in flight (up to
  hw.rounds_in_flight + 1), never by a larger round, so a request never
  waits behind more than one bounded round.
* The device work is ``pipeline.launch_round``, the batch pipeline's
  fused round (draw, heads, accept, beam decode in B1 or B3) with its
  asynchronous host copies and its event. A round's rows are read after
  that round's event, so the rounds behind it stay queued on the card
  meanwhile. Round r draws from ``pipeline.round_generator(seed, r)``.
* Dedup spans the server's lifetime (``pipeline.canonical_keys``): no
  client receives a peptide the server served before.
* A round whose within-round uniqueness collapses on the card raises
  ``pipeline.BeamCanaryError``; the worker fails every queued request and
  stops (HTTP 503, ``fatal_error`` in /stats). There is no switch to the
  plain beam.

The HTTP front end is the standard library's ThreadingHTTPServer: POST
/generate {"n": 10} blocks until n rows are ready; GET /healthz and
/stats. Run it from a trained run dir (with the states dump that
``static_eval --long`` writes) on the card:

    python -m controlled_peptide_generation_tpu_torch.serve \\
        --runname myrun --Q_select_amppos 1 --port 8800
    curl -s -X POST localhost:8800/generate -d '{"n": 25}'
"""

import json
import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from . import config as C
from . import pipeline
from .evals.peptide_evals import modlamp_from_tokens
from .utils import runtime

LOG = logging.getLogger("GenerationServer")


class _Request:
    """One client's outstanding demand: filled by the worker, waited on by
    the client thread. ``failed`` marks a request cancelled by stop() or a
    fatal error, so generate() raises instead of returning a short row
    list."""

    __slots__ = ("n", "rows", "event", "failed")

    def __init__(self, n):
        self.n = n
        self.rows = []
        self.event = threading.Event()
        self.failed = False


def _host(a):
    """A round output as a numpy array (CPU tensors and arrays alike)."""
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class GenerationServer:
    """Coalescing generation service over bounded fused CLaSS rounds.

    Construct with what ``pipeline.run_from_states`` builds (model and
    params on ``device``, the vocab, Q with its attribute heads), or with
    :func:`build_server` from a trained run dir. Runs on CUDA unless
    ``device`` is the CPU; without CUDA it raises."""

    def __init__(self, cfg, model, params, vocab, Q, round_size=5000,
                 device="cuda"):
        self.device = runtime.setup(device)
        pipeline._check_slice(cfg)
        self.cfg = cfg
        self.model = model
        self.params = params
        self.vocab = vocab
        self.Q = Q
        self.round_size = int(round_size)
        self._seen = set()
        self._queue = deque()          # FIFO of _Request
        # unique accepted rows nobody took (a timed-out request's partial
        # fill, a round's over-yield): served before new rounds run, since
        # they are already in the lifetime dedup set
        self._spare = deque()
        # the transformer's KV-cache lane budget, as run_from_states
        # clamps its rounds
        self._max_candidates = pipeline.transformer_dispatch_budget(
            cfg, model)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._running = False
        self._worker = None
        self._round_ix = 0
        self._depth = max(int(cfg.hw.get("rounds_in_flight", 2)), 1) + 1
        self.stats = {"rounds": 0, "candidates": 0, "accepted": 0,
                      "served": 0, "duplicates": 0, "device_s": 0.0,
                      "started_at": None}

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._worker is not None:
            raise RuntimeError("already started")
        self._running = True
        self.stats["started_at"] = time.time()
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="class-rounds", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout=60):
        """Stop the worker (it ends after the round it is reading) and fail
        every request still queued."""
        with self._wake:
            self._running = False
            self._wake.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        with self._lock:
            while self._queue:
                req = self._queue.popleft()
                req.failed = True
                req.event.set()

    # -- client API ---------------------------------------------------------

    def generate(self, n, timeout=None):
        """Block until n accepted peptides, unique over the server's
        lifetime, are ready; returns a list of row dicts (peptide, the
        score columns, H, uH, charge). Raises TimeoutError on timeout
        (the partial fill goes back to the spare rows), RuntimeError if
        the server stops first, ValueError on a non-positive n."""
        n = int(n)
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        req = _Request(n)
        with self._wake:
            if not self._running:
                raise RuntimeError("server not running")
            self._queue.append(req)
            self._wake.notify_all()
        if not req.event.wait(timeout):
            with self._lock:
                try:
                    self._queue.remove(req)
                    self._spare.extend(req.rows)
                    req.rows = []
                except ValueError:
                    pass  # the worker completed it meanwhile
            if not req.event.is_set():
                raise TimeoutError(
                    f"generate({n}) timed out after {timeout}s "
                    f"(0 of {n} delivered; partial fill recycled)")
        if req.failed:
            raise RuntimeError(
                f"server stopped with generate({n}) incomplete "
                f"({len(req.rows)} of {n} ready)")
        return req.rows

    # -- worker --------------------------------------------------------------

    def _outstanding(self):
        return sum(r.n - len(r.rows) for r in self._queue)

    def _distribute_locked(self, rows):
        """Hand rows to the queued requests FIFO (the caller holds the
        lock); rows left over go to the spare rows. 'served' counts the
        rows of completed requests only."""
        for i, row in enumerate(rows):
            if not self._queue:
                self._spare.extend(rows[i:])
                return
            req = self._queue[0]
            req.rows.append(row)
            if len(req.rows) >= req.n:
                self.stats["served"] += req.n
                self._queue.popleft()
                req.event.set()

    def _worker_loop(self):
        """Keep up to ``_depth`` bounded rounds in flight until their
        expected yield covers the demand, and read the oldest; a device
        out-of-memory error halves the round cap and goes on, any other
        error fails every queued request."""
        inflight = deque()
        while True:
            with self._wake:
                while True:
                    if self._spare and self._queue:
                        spare, self._spare = list(self._spare), deque()
                        self._distribute_locked(spare)
                    if not self._running:
                        return
                    if self._outstanding() > 0 or inflight:
                        break
                    self._wake.wait()
                demand = self._outstanding()
                rates = self._rates_locked()
            cur = None
            try:
                expected = sum(self._expected_yield(n, rates)
                               for (n, _, _) in inflight)
                while len(inflight) < self._depth and (
                        not inflight or expected < demand):
                    n = self._round_size_bounded()
                    inflight.append(self._launch_guarded(n))
                    expected += self._expected_yield(n, rates)
                cur = inflight.popleft()
                rows = self._finish_round(cur)
            except Exception as e:
                n_round = (cur[0] if cur is not None
                           else inflight[0][0] if inflight else None)
                inflight.clear()
                if pipeline.is_device_oom(e) and n_round is not None:
                    shrink = n_round // 2
                    if shrink >= 1:
                        LOG.warning("out of device memory at %d candidates; "
                                    "capping rounds at %d and retrying",
                                    n_round, shrink)
                        self._max_candidates = shrink
                        continue
                LOG.exception("fatal error in the round worker; failing %d "
                              "queued requests", len(self._queue))
                self._fail_all(e)
                return
            with self._wake:
                self._distribute_locked(rows)

    def _fail_all(self, exc):
        """Fatal-error teardown: refuse new work and fail every queued
        request, so clients raise instead of waiting forever."""
        with self._wake:
            self._running = False
            self.stats["fatal_error"] = f"{type(exc).__name__}: {exc}"
            while self._queue:
                req = self._queue.popleft()
                req.failed = True
                req.event.set()
            self._wake.notify_all()

    def _rates_locked(self):
        """(acceptance rate, unique-after-dedup rate) observed so far, with
        floors of 0.05 and 0.1 (before any round: 0.05 and 1.0). The
        caller holds the lock."""
        acc = self.stats["accepted"] / max(self.stats["candidates"], 1)
        uniq = 1.0 - (self.stats["duplicates"]
                      / max(self.stats["accepted"], 1))
        return max(acc, 0.05), max(uniq, 0.1)

    def _expected_yield(self, n, rates):
        """Expected unique accepted rows of a round of n candidates."""
        acc, uniq = rates
        return n * acc * uniq

    def _round_size_bounded(self):
        """Candidates of the next round: one round_size, capped by the
        transformer's lane budget (or by an out-of-memory halving)."""
        cap = self._max_candidates
        if cap is None:
            return self.round_size
        return max(min(self.round_size, cap), 1)

    def _launch_guarded(self, n):
        """Enqueue one round; returns (n, t_launch, (host, event)) for
        _finish_round. An out-of-memory error halves the round and
        retries, down to one candidate."""
        self._round_ix += 1
        t0 = time.perf_counter()
        while True:
            try:
                out = pipeline.launch_round(
                    self.cfg, self.model, self.params, self.Q, n,
                    pipeline.round_generator(self.cfg.seed, self._round_ix,
                                             self.device))
                return n, t0, out
            except Exception as e:
                shrink = n // 2
                if not pipeline.is_device_oom(e) or shrink < 1:
                    raise
                LOG.warning("round out of device memory at %d candidates; "
                            "retrying at %d", n, shrink)
                self._max_candidates = n = shrink

    def _finish_round(self, pending):
        """Wait for one round's event, read its host copies, then dedup,
        detokenize and physchem on the host; returns the row dicts.
        ``pending`` is (n, t_launch, (host, event)), host the raw tuple
        (z, scores dict, accept, tokens, valid) of CPU tensors or arrays,
        event None where there is none to wait on. The device stage
        starts at launch, so it includes the time the worker spent on the
        previous round meanwhile."""
        n, t0, (host, event) = pending
        if event is not None:
            event.synchronize()
        t_dev = time.perf_counter()
        _, scores, accept, tokens, valid = host
        tokens_np, accept_np = _host(tokens), _host(accept).astype(bool)
        scores_np = {k: _host(v) for k, v in scores.items()}
        n_candidates, n_accepted = accept_np.shape[0], int(accept_np.sum())
        # rows a client may receive: the valid compacted slots in
        # accepted-only mode, the accepted rows in decode-all
        keep_rows = accept_np if valid is None else _host(valid).astype(bool)
        tokens_np = tokens_np[keep_rows]
        scores_np = {k: s[keep_rows] for k, s in scores_np.items()}
        t_d2h = time.perf_counter()
        row_keys = list(pipeline.canonical_keys(tokens_np))
        pipeline.beam_canary_check(
            self.cfg, self.device, len(row_keys), len(set(row_keys)),
            context=f"serve round {self._round_ix}")
        keep = np.empty(tokens_np.shape[0], bool)
        for i, rb in enumerate(row_keys):
            keep[i] = rb not in self._seen
            self._seen.add(rb)
        dup = int(keep.size - keep.sum())
        kept_tokens = tokens_np[keep].astype(np.int64)
        peptides = self.vocab.to_sentences_batch(kept_tokens,
                                                 print_special_tokens=False)
        H, uH, charge = modlamp_from_tokens(kept_tokens, self.vocab.itos)
        t1 = time.perf_counter()
        s_dev, s_d2h, s_host = t_dev - t0, t_d2h - t_dev, t1 - t_d2h
        with self._lock:
            self.stats["rounds"] += 1
            self.stats["candidates"] += n_candidates
            self.stats["accepted"] += n_accepted
            self.stats["duplicates"] += dup
            self.stats["device_s"] += t1 - t0
            st = self.stats.setdefault(
                "stage_s", {"dispatch_device": 0.0, "d2h": 0.0,
                            "host_postproc": 0.0})
            st["dispatch_device"] += s_dev
            st["d2h"] += s_d2h
            st["host_postproc"] += s_host
        LOG.info("round %d: %d candidates -> %d accepted, %d unique "
                 "(%.3fs = %.3f dev + %.3f d2h + %.3f host)", self._round_ix,
                 n_candidates, n_accepted, len(peptides), t1 - t0, s_dev,
                 s_d2h, s_host)
        score_cols = {k: s[keep] for k, s in scores_np.items()}
        rows = []
        for i, pep in enumerate(peptides):
            row = {"peptide": pep, "H": float(H[i]), "uH": float(uH[i]),
                   "charge": float(charge[i])}
            for k, s in score_cols.items():
                row[k] = float(s[i])
            rows.append(row)
        return rows

    # -- introspection -------------------------------------------------------

    def stats_snapshot(self):
        with self._lock:
            out = dict(self.stats)
            out["outstanding"] = self._outstanding()
            out["unique_seen"] = len(self._seen)
        up = time.time() - out["started_at"] if out["started_at"] else 0.0
        out["uptime_s"] = up
        out["accepted_per_s"] = out["accepted"] / max(up, 1e-9)
        return out


# ---------------------------------------------------------------------------
# HTTP front end (standard library only)
# ---------------------------------------------------------------------------

def make_http_server(server, host="127.0.0.1", port=8800, max_n=100_000,
                     request_timeout=600.0):
    """Wrap a started GenerationServer in a ThreadingHTTPServer.

    POST /generate {"n": 10[, "timeout": s]} -> {"n": 10, "samples": [...]}
    (400 on a malformed body or n outside [1, max_n], 504 on timeout, 503
    when the server stopped); GET /healthz -> {"ok", "backend" ("cuda" or
    "cpu"), "n_devices"}; GET /stats -> the counters; 404 elsewhere."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        # the default listen backlog of 5 overflows under a burst of
        # concurrent clients (connection resets, multi-second waits
        # before a request reaches its handler)
        request_queue_size = 128

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                cuda = server.device.type == "cuda"
                self._json(200, {"ok": True, "backend": server.device.type,
                                 "n_devices": (torch.cuda.device_count()
                                               if cuda else 1)})
            elif self.path == "/stats":
                self._json(200, server.stats_snapshot())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                n = int(payload.get("n", 1))
                timeout = float(payload.get("timeout", request_timeout))
            except (json.JSONDecodeError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if not 0 < n <= max_n:
                self._json(400, {"error": f"n must be in [1, {max_n}]"})
                return
            try:
                rows = server.generate(n, timeout=timeout)
                self._json(200, {"n": len(rows), "samples": rows})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except RuntimeError as e:  # the server stopped mid-request
                self._json(503, {"error": str(e)})

        def log_message(self, fmt, *a):
            LOG.debug("%s " + fmt, self.address_string(), *a)

    return _Server((host, port), Handler)


def build_server(cfg, args, device="cuda"):
    """Load a trained run dir (model, vocab, the states dump), fit Q and
    the two attribute heads as ``pipeline.run_from_states`` does, build
    the family's beam kernel on the card (nvcc runs here, not inside the
    first request; nothing is launched), and return an unstarted
    GenerationServer. Runs on CUDA unless ``device`` is the CPU."""
    from .api import get_model_and_vocab_path, load_trained_model, load_vocab
    device = runtime.setup(device)
    pipeline._check_slice(cfg)
    model_path, vocab_path, _ = get_model_and_vocab_path(cfg)
    vocab = load_vocab(vocab_path)
    model, params = load_trained_model(model_path, vocab.size(), cfg,
                                       device=device)
    states = pipeline.load_states(cfg)
    qkwargs = dict(pipeline.Q_KWARGS)
    for k in qkwargs:
        if hasattr(args, "Q_" + k):
            qkwargs[k] = getattr(args, "Q_" + k)
    QClass = pipeline.resolve_QClass(getattr(args, "QClass", "mogQ"))
    q_select = {"amp": 1} if args.Q_select_amppos else {}
    Q, _ = pipeline.fitQ_and_test(cfg, QClass, qkwargs, states, q_select,
                                  device=device)
    attributes = C.dataset_spec(cfg)["attributes"]
    Q.init_attr_classifiers(
        {attr: pipeline.build_clfZ(cfg, attr, states, attributes, device)
         for attr in ("amp", "tox")}, clf_targets={"amp": 1, "tox": 0})
    if device.type == "cuda":
        if model.G_class == "transformer":
            from .ops import tfm_beam_kernel as kernel
        else:
            from .ops import beam_kernel as kernel
        kernel.build()
    return GenerationServer(cfg, model, params, vocab, Q,
                            round_size=args.n_samples_per_round,
                            device=device)


EXTRA_ARGS = [
    ("--QClass", dict(default="mogQ")),
    ("--Q_n_components", dict(type=int, default=100,
                              help="mog num components for Q model")),
    ("--Q_covariance_type", dict(default="diag",
                                 help="mog Q covariance type full|tied|diag")),
    ("--n_samples_per_round", dict(type=int, default=5000,
                                   help="candidates per fused round")),
    ("--Q_select_amppos", dict(type=int, default=0,
                               help="fit Q_xi on amp-positive selection")),
    ("--host", dict(default="127.0.0.1", help="bind address")),
    ("--port", dict(type=int, default=8800, help="bind port")),
    ("--max_n", dict(type=int, default=100_000,
                     help="largest n a single /generate may request")),
    ("--device", dict(default="cuda", help="cuda (default) or cpu")),
]


def main(argv=None):
    """Serve a trained run dir over HTTP until interrupted."""
    cfg, args, _ = C.parse_and_finalize(argv, extra_args=EXTRA_ARGS)
    device = runtime.setup(args.device)
    C.pretty_print(cfg)
    server = build_server(cfg, args, device=device).start()
    httpd = make_http_server(server, host=args.host, port=args.port,
                             max_n=args.max_n)
    LOG.info("Serving on http://%s:%d (POST /generate, GET /healthz, "
             "GET /stats)", args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d/%Y %I:%M:%S %p", level=logging.INFO)
    main()
