"""Closed-loop traffic against the port's CLaSS generation service.

The program under test is ``serve.GenerationServer`` built in-process on
the cell's configuration, serving one fixed model as a deployment does:
its weights made on the device from the mix's ``model_seed``, the linear
maps at ``weight_gain`` times their initial scale (so that, untrained, the
decoder's rows depend on z); Q(z) a diagonal mixture fitted in set-up to a
synthetic latent corpus drawn from the run's seed; two fixed logistic
heads. The seed draws the traffic: the corpus, Q's fit, every round's
draws and the order of the request sizes. ``clients`` threads each call ``generate(n)`` and, once it returns,
the next; the sizes n are one fixed set for every seed (log-uniform
quantiles between ``n_min`` and ``n_max``), dealt to the clients in an
order drawn from the seed. Set-up runs the same loop until
``warmup_rounds`` rounds have been served, then lets every client finish.

The window opens when all clients start together and closes when the last
request made before ``--seconds`` returns: ``accepted_per_s`` is every row
those requests received over that time, ``request_ms.p95`` the 95th
percentile of all their latencies (call to return, host clock).

Correctness, once the server has stopped: the reference refits Q from the
same corpus and draws, replays every round the server finished from (seed,
round), and for a sample of the window's rows drawn from the seed (with
the longest peptide among them) finds the candidate whose head scores the
row carries, then checks the row's accept test, its peptide against the
reference's beam decode of that candidate, and its physicochemical
columns against the peptide; every served peptide must be distinct.
"""

import copy
import random
import threading
import time

import torch

from .. import harness, weights
from ..reference import beam as ref_beam
from ..reference import latent as ref_latent
from ..reference.common import full_fp32, generator, onehot
from ..reference.physchem import CHARGE, EISENBERG, physchem
from .port import device_info, dim_flags

def request_sizes(mix, seed):
    """Every client's list of request sizes: one fixed multiset (quantiles
    of the log-uniform law), shuffled by the seed, dealt round-robin."""
    m, lo, hi = mix["sizes_per_client"] * mix["clients"], mix["n_min"], mix["n_max"]
    sizes = [int(round(lo * (hi / lo) ** ((i + 0.5) / m))) for i in range(m)]
    random.Random(seed).shuffle(sizes)
    return [sizes[c::mix["clients"]] for c in range(mix["clients"])]


def latent_corpus(config, mix, seed, device):
    """The encoder outputs Q is fitted to: mu = scale * N(0, 1), a fixed
    logvar."""
    gen = generator(device, seed, 3)
    mu = mix["corpus_mu_scale"] * torch.randn(
        (mix["corpus_rows"], config["z_dim"]), generator=gen, device=device)
    return mu, torch.full_like(mu, mix["corpus_logvar"])


def head_params(config, mix, device):
    """(w [A, Z], b [A], targets [A]) of the heads, in name order."""
    names = sorted(mix["heads"])
    w = torch.zeros((len(names), config["z_dim"]), device=device)
    for i, a in enumerate(names):
        for j, v in mix["heads"][a]["w"].items():
            w[i, int(j)] = v
    b = torch.tensor([mix["heads"][a]["b"] for a in names], device=device)
    t = torch.tensor([mix["heads"][a]["target"] for a in names], device=device)
    return names, w, b, t


def port_flags(config, mix, seed, extra=()):
    return (dim_flags(config) + list(mix.get("flags", ()))
            + ["--seed", str(seed)] + list(extra))


def flag(flags, name, default):
    """The value that follows ``name`` in a flag list (the last one)."""
    vals = [flags[i + 1] for i, f in enumerate(flags[:-1]) if f == name]
    return vals[-1] if vals else default


def round_size(config, flags, n):
    """Candidates a round of ``n``: capped, for the transformer decoder, by
    its KV-cache lane budget (``--hw.tfm_lane_budget_gb`` bytes over six
    times a candidate's raw cache bytes: 5 beams of L layers' K and V rows
    in the decode type)."""
    if config["family"] != "transformer":
        return n
    elem = 2 if flag(flags, "--hw.gen_dtype", "float32") == "bfloat16" else 4
    per = (config["n_layers"] * (config["max_seq_len"] + 1) * config["d_model"]
           * 2 * elem * 5)
    budget = float(flag(flags, "--hw.tfm_lane_budget_gb", "4.0"))
    return min(n, max(int(int(budget * 2 ** 30) / (6 * per)), 1))


def build(run, device, extra_flags=()):
    """The program under test: an unstarted GenerationServer."""
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch import serve
    from controlled_peptide_generation_tpu_torch.data.vocab import Vocab
    from controlled_peptide_generation_tpu_torch.latent import density, logreg
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import build_model
    config, mix = run.config, run.traffic
    cfg, _, _ = C.parse_and_finalize(
        port_flags(config, mix, run.seed, extra_flags))
    model = build_model(cfg.model, config["n_vocab"], config["max_seq_len"])
    params = weights.make(config, mix["model_seed"], device,
                          mix["weight_gain"])
    mu, logvar = latent_corpus(config, mix, run.seed, device)
    Q = density.mogQ(mu, logvar, n_components=mix["q_components"],
                     z_num_samples=mix["q_samples"], covariance_type="diag",
                     gen=generator(device, run.seed, 2), device=device)
    names, w, b, t = head_params(config, mix, device)
    Q.init_attr_classifiers(
        {a: logreg.LogRegParams(w=w[i], b=b[i]) for i, a in enumerate(names)},
        {a: int(t[i]) for i, a in enumerate(names)})
    if device.type == "cuda":
        if model.G_class == "transformer":
            from controlled_peptide_generation_tpu_torch.ops import (
                tfm_beam_kernel as kernel)
        else:
            from controlled_peptide_generation_tpu_torch.ops import (
                beam_kernel as kernel)
        kernel.build()
    server = serve.GenerationServer(cfg, model, params, Vocab(config["itos"]),
                                    Q, round_size=mix["round_size"],
                                    device=device)
    return server



class _WorkerTrace:
    """The traced run's profiler window, opened and closed in the server's
    worker thread, the one thread that launches every round (a profiler
    started on another thread records none of that thread's work): the
    port's ``pipeline.launch_round`` is wrapped while the window is armed,
    and the first launch at or after the start opens it, the first launch
    ``trace_s`` later closes it."""

    def __init__(self, mix, seconds):
        from controlled_peptide_generation_tpu_torch import pipeline
        self.pipeline = pipeline
        self.length = min(mix["trace_s"], 0.5 * seconds)
        self.window, self.closed = None, False
        self.start_at, self._orig = None, pipeline.launch_round

    def warm(self):
        """Start and stop the profiler once in the worker thread, at its
        next launch: its first start in a process takes seconds, which a
        window opened later would otherwise spend inside the run."""
        from ..trace import warm

        def launch(*a, **k):
            self.pipeline.launch_round = self._orig
            warm()
            return self._orig(*a, **k)

        self.pipeline.launch_round = launch

    def arm(self, start_at):
        from ..trace import Window
        self.start_at = start_at

        def launch(*a, **k):
            now = time.perf_counter()
            if self.window is None and now >= self.start_at:
                self.window = Window().__enter__()
                self._opened = time.perf_counter()
            elif (not self.closed and self.window is not None
                  and now - self._opened >= self.length):
                self.window.__exit__(None, None, None)
                self.closed = True
            return self._orig(*a, **k)

        self.pipeline.launch_round = launch

    def disarm(self):
        self.pipeline.launch_round = self._orig

    def result(self):
        if self.window is not None and not self.closed:
            # a profiler left running crashes the interpreter's teardown
            raise RuntimeError("the traced window opened but no launch "
                               "came to close it")
        return {"window": self.window} if self.closed else {}


class Clients:
    """Client threads in a closed loop over ``server.generate``; each keeps
    its place in its list of sizes from one phase to the next."""

    def __init__(self, server, sizes, timeout):
        self.server, self.sizes, self.timeout = server, sizes, timeout
        self.pos = [0] * len(sizes)
        self.records, self.failures = [], 0
        self._lock = threading.Lock()

    def _loop(self, c, barrier, stop):
        barrier.wait()
        while not stop():
            n = self.sizes[c][self.pos[c] % len(self.sizes[c])]
            self.pos[c] += 1
            t0 = time.perf_counter()
            try:
                rows = self.server.generate(n, timeout=self.timeout)
            except (TimeoutError, RuntimeError):
                rows = None
            with self._lock:
                self.failures += rows is None
                self.records.append((t0, time.perf_counter(), n, rows))

    def run(self, stop):
        """Start every client at once and let each loop until ``stop()``
        holds before its next request. Returns (t0, the requests' records:
        (start, end, n, rows or None))."""
        self.records, self.failures = [], 0
        barrier = threading.Barrier(len(self.sizes) + 1)
        threads = [threading.Thread(target=self._loop, args=(c, barrier, stop),
                                    daemon=True)
                   for c in range(len(self.sizes))]
        for th in threads:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join()
        return t0, list(self.records)


def run(run, device, control=False):
    """Set up, measure, check. Returns the driver's result dict. With
    ``control`` the program runs with its cell's ``control_flags`` (its own
    path in the precision below the configuration's)."""
    mix = run.traffic
    extra_flags = run.cell["control_flags"] if control else ()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    server = build(run, device, extra_flags).start()
    clients = Clients(server, request_sizes(mix, run.seed),
                      mix["request_timeout_s"])
    tracer = _WorkerTrace(mix, run.seconds) if run.trace else None
    if tracer is not None:
        tracer.warm()
    warm = mix["warmup_rounds"]
    _, warm_records = clients.run(lambda: server.stats["rounds"] >= warm)
    run.log(f"set-up done: {server.stats['rounds']} rounds served in warm-up")
    before = copy.deepcopy(server.stats_snapshot())
    setup_s = time.perf_counter() - run.t_start
    deadline = time.perf_counter() + run.seconds
    if tracer is not None:
        tracer.arm(time.perf_counter() + mix["trace_lead"] * run.seconds)
    try:
        t0, records = clients.run(lambda: time.perf_counter() >= deadline)
    finally:
        if tracer is not None:
            tracer.disarm()
    traced = tracer.result() if tracer is not None else {}
    t_end = max(r[1] for r in records)
    after = copy.deepcopy(server.stats_snapshot())
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    server.stop()
    rows = [row for r in records if r[3] is not None for row in r[3]]
    peptides = [row["peptide"] for r in warm_records + records
                if r[3] is not None for row in r[3]]
    latencies = [1e3 * (r[1] - r[0]) for r in records]
    e2e = {"accepted_per_s": len(rows) / (t_end - t0),
           "request_ms.p95": harness.percentile(latencies, 95),
           "setup_s": setup_s}
    run.log(f"window: {len(records)} requests, {len(rows)} rows in "
            f"{t_end - t0:.3f} s; {after['rounds'] - before['rounds']} rounds")
    n_rounds = server.stats["rounds"]
    n = round_size(run.config, port_flags(run.config, mix, 0, extra_flags),
                   mix["round_size"])
    del server
    numbers = check_rows(run, device, rows, n_rounds, n, control)
    numbers["duplicates"] = len(peptides) - len(set(peptides))
    ctx = {"config": run.config, "before": before, "after": after,
           "traced": traced, "round_size": n, "window_s": t_end - t0}
    out = {"numbers": numbers, "attempted": len(records),
           "failed": sum(r[3] is None for r in records), "e2e": e2e,
           "ctx": ctx, "device": device_info(device, memory_peak)}
    if traced:
        w = traced["window"]
        out["device"].update(busy_s=w.busy_s(), window_s=w.window_s)
        out["breakdown"] = w.breakdown()
    return out


def _nearest(served, cand, chunk=1 << 18):
    """For each served row [S, C] the candidate [N, C] nearest by the
    largest absolute difference of its columns: (distance [S], index [S])."""
    best_d = torch.full((served.shape[0],), float("inf"), device=cand.device)
    best_i = torch.zeros((served.shape[0],), dtype=torch.long,
                         device=cand.device)
    for s in range(0, cand.shape[0], chunk):
        d = (served[:, None, :] - cand[None, s:s + chunk, :]).abs().amax(2)
        v, i = d.min(1)
        better = v < best_d
        best_d = torch.where(better, v, best_d)
        best_i = torch.where(better, i + s, best_i)
    return best_d, best_i


def _physchem_bf16(peptide):
    """(H, uH, charge) computed in bfloat16: the control's columns."""
    res = peptide.split()
    if not res:
        return 0.0, 0.0, 0.0
    bf = torch.bfloat16
    h = torch.tensor([EISENBERG.get(a, 0.0) for a in res], dtype=bf)
    ang = torch.deg2rad(100.0 * torch.arange(len(res), dtype=bf))
    n = torch.tensor(float(len(res)), dtype=bf)
    mom = torch.hypot((h * torch.cos(ang)).sum(), (h * torch.sin(ang)).sum())
    charge = torch.tensor([float(CHARGE.get(a, 0)) for a in res], dtype=bf)
    return float(h.sum() / n), float(mom / n), float(charge.sum())


def check_rows(run, device, rows, n_rounds, n, control=False):
    """The compared numbers of a run's served rows (each a gap or a count;
    larger is worse): score_gap, the largest difference between a sampled
    row's head scores and its candidate's; accept_gap, by how much the
    reference's accept test fails the sampled rows at worst (0 where all
    pass); decode_mismatch, the share of sampled rows whose peptide is not
    the reference's decode of the candidate; physchem_gap, the largest
    difference of H, uH or charge from the peptide's. ``n_rounds`` rounds
    of ``n`` candidates were served. With ``control`` the first three are
    read off the reference put in the program's place in bfloat16 (its
    heads, its accept test, its physicochemical columns), the precision
    below the configuration's."""
    full_fp32()
    config, mix = run.config, run.traffic
    mu, logvar = latent_corpus(config, mix, run.seed, device)
    q = ref_latent.fit_mogQ(mu, logvar, mix["q_components"], mix["q_samples"],
                            generator(device, run.seed, 2))
    names, w, b, t = head_params(config, mix, device)
    cols = [f"clfZ_{a}={int(t[i])}" for i, a in enumerate(names)]
    zs, cbits, us, cand = [], [], [], []
    for r in range(1, n_rounds + 1):
        d = ref_latent.round_draws(generator(device, run.seed, r), q, n)
        z = ref_latent.sample(q, d)
        probs, accum = ref_latent.heads(z, w, b, t)
        zs.append(z)
        cbits.append(d.cbit)
        us.append(d.u)
        cand.append(torch.cat([probs, accum[:, None]], 1))
    zs, cbits, us, cand = (torch.cat(a) for a in (zs, cbits, us, cand))
    rng = random.Random(run.seed * 7919 + 17)
    pick = rng.sample(range(len(rows)), min(mix["check_rows"], len(rows)))
    longest = max(range(len(rows)), key=lambda i: len(rows[i]["peptide"]))
    if longest not in pick:
        pick.append(longest)
    sample = [rows[i] for i in pick]
    served = torch.tensor([[row[c] for c in cols] + [row["clfZ_prob_accum"]]
                           for row in sample], device=device)
    gap, idx = _nearest(served, cand)
    accept_gap = float((us[idx] - cand[idx, -1]).clamp(min=0.0).max())
    toks, _ = ref_beam.beam_search(config, weights.make(
        config, mix["model_seed"], device, mix["weight_gain"]), zs[idx],
        onehot(cbits[idx], config["c_dim"]))
    itos = config["itos"]
    ref_peps = [" ".join(itos[int(x)] for x in row if int(x) > 3)
                for row in toks.cpu().tolist()]
    mismatch = sum(p != row["peptide"] for p, row in zip(ref_peps, sample))
    phys = max(abs(a - row[k]) for row in sample
               for a, k in zip(physchem(row["peptide"]), ("H", "uH", "charge")))
    run.log(f"checked {len(sample)} of {len(rows)} rows over {n_rounds} "
            f"rounds of {n}: {mismatch} decodes differ")
    out = {"score_gap": float(gap.max()), "accept_gap": accept_gap,
           "decode_mismatch": mismatch / len(sample), "physchem_gap": phys}
    if control:
        bf = torch.bfloat16
        pb, ab = ref_latent.heads(zs.to(bf), w.to(bf), b.to(bf), t)
        cb = torch.cat([pb, ab[:, None]], 1).float()
        out["score_gap"] = float((cb[idx] - cand[idx]).abs().max())
        taken = us < cb[:, -1]
        out["accept_gap"] = float((us - cand[:, -1])[taken].clamp(min=0.0)
                                  .max()) if bool(taken.any()) else 0.0
        out["physchem_gap"] = max(
            abs(a - c) for row in sample for a, c in zip(
                _physchem_bf16(row["peptide"]), physchem(row["peptide"])))
    return out
