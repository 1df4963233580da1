"""Phase-1 training traffic: the port's phase-1 loop, ``train_vae``, on a
synthetic corpus.

The program under test is ``train/train_vae.py:train_vae`` as
``main --phase 1`` runs it after its file reads: its loader
(``AttributeDataLoader`` over the corpus of ``gen/corpus.py``, written
once under the temporary directory), the weights made from the seed, the
program's ``MetricLogger`` (in memory), and the loop with its default
cadences (the mix's flags): step 0 eager, every later run of
``--hw.unroll`` steps one chunk (one CUDA graph on the card), the host's
work at each boundary (a sample sentence and the deferred fetch of the
logged values every ``cheaplog_every`` steps; the held-out eval and a
checkpoint, written under the temporary directory, every
``expsvlog_every``). One ``train_vae`` call runs set-up and window alike.
The harness sees it through the step and the chunk that the loop builds
(``make_train_step`` and ``make_train_chunk``, each wrapped so that its
calls pass through to the program's own): it reads the check's numbers
off the first three calls (step 0, two chunks), lets ``warmup_chunks``
more run, and opens the window at the next chunk call, once the device
has caught up. The window closes at the first chunk call after
``--seconds``, before it launches: the loop stops there, and the window
ends when the device has finished what was launched.
``train_seqs_per_s`` is the window's steps times the batch over its
length.

Correctness, once the program's state is freed: the reference trains the
same initial weights on the same batches (those the loop fed its step and
chunks, each checked to be a row of the corpus) with the same draws
through the same 2 * unroll + 1 steps, and each compared number is a gap
between program and reference: the loss of each of the three calls
(relative), the logged full-kernel MMD after the third (relative), the
per-leaf norm of the first gradient as Adam took it (read from its first
moment after step 0), and of each leaf's change after the three calls,
each against the larger of the reference leaf's norm and the median
leaf's. Leaves whose first reference gradient is below a thousandth of
the median leaf's move by round-off alone and are left out of the
change.
"""

import hashlib
import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from .. import weights
from ..gen import corpus
from ..reference import train as ref_train
from ..reference.common import full_fp32
from ..reference.models import leaves
from .port import device_info, dim_flags

ADAM_B1 = 0.9


def corpus_dir(mix):
    """The corpus of the mix's parameters, written once under the temporary
    directory (a directory named by its parameters; written aside, then
    moved into place)."""
    params = {k: mix["corpus"][k] for k in sorted(mix["corpus"])}
    tag = hashlib.sha256(json.dumps(params).encode()).hexdigest()[:16]
    base = os.path.join(tempfile.gettempdir(), "portbench", f"corpus_{tag}")
    data = os.path.join(base, "synthetic")
    if not os.path.exists(os.path.join(data, "_gen_meta.json")):
        tmp = f"{base}.part{os.getpid()}"
        corpus.generate(os.path.join(tmp, "synthetic"), **params)
        os.makedirs(os.path.dirname(base), exist_ok=True)
        try:
            os.rename(tmp, base)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
    return base


def build(run, device, out_dir):
    """(port cfg, model, dataset, params) as ``main --phase 1`` makes them,
    the weights from the seed; checkpoints go under ``out_dir``."""
    from controlled_peptide_generation_tpu_torch import config as C
    from controlled_peptide_generation_tpu_torch.data.loader import (
        AttributeDataLoader)
    from controlled_peptide_generation_tpu_torch.models.rnn_vae import build_model
    from controlled_peptide_generation_tpu_torch.utils import runtime
    config, mix = run.config, run.traffic
    cfg, _, _ = C.parse_and_finalize(
        dim_flags(config) + list(mix.get("flags", ()))
        + ["--phase", "1", "--dataset", "synthetic",
           "--datapath", corpus_dir(mix), "--seed", str(run.seed),
           "--savepath_toplevel", out_dir])
    runtime.set_full_fp32()
    spec = C.dataset_spec(cfg)
    spec.pop("synthetic", None)
    dataset = AttributeDataLoader(mbsize=cfg.vae.batch_size,
                                  max_seq_len=cfg.max_seq_len,
                                  iterator_seed=run.seed % 2 ** 31, **spec)
    if dataset.n_vocab != config["n_vocab"]:
        raise ValueError(f"corpus vocabulary {dataset.n_vocab} != "
                         f"{config['n_vocab']}")
    model = build_model(cfg.model, dataset.n_vocab, cfg.max_seq_len)
    params = weights.make(config, run.seed, device)
    return cfg, model, dataset, params


def _flat(tree):
    return {"/".join(map(str, p)): v for p, v in leaves(tree)}


class _WindowClosed(Exception):
    """Raised at the first chunk call after the window's length: it stops
    the loop before that chunk launches."""


class Watch:
    """What the harness reads off the loop's step and chunk calls: the
    first three calls' batches, losses and MMD, Adam's first moment after
    step 0, the weights after the third call; then the window (and, in a
    traced run, the profiler's window inside it) at chunk boundaries."""

    def __init__(self, run, device, params):
        self.run, self.device, self.params = run, device, params
        mix = run.traffic
        self.fed, self.metrics = [], []
        self.first_grad = self.after3 = None
        self.calls = 0
        self.window_at = 3 + mix["warmup_chunks"]
        self.t0 = self.it0 = self.stop_it = None
        self.trace_lead, self.trace_s = mix["trace_lead"], mix["trace_s"]
        self.trace_host = mix["trace_host"]
        self.trace_at = self.window = self._traced_from = None
        self.traced = {}
        self.chunk = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap_step(self, make_train_step):
        def make(*a, **k):
            step, optimizer = make_train_step(*a, **k)

            def watched(params, opt_state, text, it, draws):
                metrics = step(params, opt_state, text, it, draws)
                if self.calls == 0:
                    self._record(text.cpu().numpy()[None], metrics)
                    self.first_grad = {
                        name: v.detach() / (1.0 - ADAM_B1)
                        for name, v in _flat(opt_state["mu"]).items()}
                return metrics
            return watched, optimizer
        return make

    def _record(self, texts, metrics):
        self.fed.append(np.array(texts))
        self.metrics.append({k: metrics[k].detach().clone()
                             for k in ("L_vae", "L_wae_mmd")})
        self.calls += 1

    def wrap_chunk(self, make_train_chunk):
        def make(*a, **k):
            self.chunk = make_train_chunk(*a, **k)
            return _Chunk(self, self.chunk)
        return make

    def chunk_call(self, chunk, params, opt_state, texts, it):
        if self.calls < 3:
            metrics = chunk(params, opt_state, texts, it)
            self._record(texts, metrics)
            if self.calls == 3:
                self._sync()
                self.after3 = {name: v.detach().clone()
                               for name, v in _flat(self.params).items()}
            return metrics
        now = time.perf_counter()
        if self.t0 is None:
            if self.calls >= self.window_at:
                self._sync()
                self.t0, self.it0 = time.perf_counter(), it
                self.trace_at = self.t0 + self.trace_lead * self.run.seconds
                self.run.log(f"set-up done at step {it}")
        elif now - self.t0 >= self.run.seconds:
            if self.window is not None and not self.traced:
                self._close_trace(it)
            self.stop_it = it
            raise _WindowClosed()
        elif self.run.trace:
            self._trace(now, it)
        self.calls += 1
        return chunk(params, opt_state, texts, it)

    def _trace(self, now, it):
        from ..trace import Window
        if self.window is None and now >= self.trace_at:
            opened = time.perf_counter()
            self.window = Window(host=self.trace_host).__enter__()
            self._traced_from = (time.perf_counter(), it, opened)
        elif (self.window is not None and not self.traced
              and now - self._traced_from[0]
              >= min(self.trace_s, 0.5 * self.run.seconds)):
            self._close_trace(it)

    def _close_trace(self, it):
        self.window.__exit__(None, None, None)
        self.traced = {"window": self.window,
                       "steps": it - self._traced_from[1],
                       "wall_s": time.perf_counter() - self._traced_from[2]}


class _Chunk:
    """The loop's chunk, its calls passed to ``Watch``; everything else is
    the program's chunk's own."""

    def __init__(self, watch, chunk):
        self._watch, self._chunk = watch, chunk

    def __call__(self, params, opt_state, texts, it0):
        return self._watch.chunk_call(self._chunk, params, opt_state, texts,
                                      it0)

    def __getattr__(self, name):
        return getattr(self._chunk, name)


def run(run, device, control=False):
    """Set up, measure, check. Returns the driver's result dict. With
    ``control`` the program's products run in TF32 (the torch flags), the
    precision below the configuration's float32."""
    from controlled_peptide_generation_tpu_torch.train import train_vae as TV
    from controlled_peptide_generation_tpu_torch.utils.logging import (
        MetricLogger)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out_dir = os.path.join(tempfile.gettempdir(), "portbench", "train_out")
    cfg, model, dataset, params = build(run, device, out_dir)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if run.trace:
        from ..trace import warm
        warm(run.traffic["trace_host"])
    watch = Watch(run, device, params)
    made = TV.make_train_step, TV.make_train_chunk
    TV.make_train_step = watch.wrap_step(made[0])
    TV.make_train_chunk = watch.wrap_chunk(made[1])
    try:
        TV.train_vae(cfg, model, dataset, params, logger=MetricLogger(None))
    except _WindowClosed:
        pass
    finally:
        TV.make_train_step, TV.make_train_chunk = made
    if watch.stop_it is None:
        raise RuntimeError(f"the loop ended ({cfg.vae.n_iter} steps) "
                           f"before the window closed")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - watch.t0
    steps = watch.stop_it - watch.it0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    run.log(f"window: steps {watch.it0} to {watch.stop_it} in "
            f"{window_s:.3f} s")
    chunk = watch.chunk
    graph = chunk.stats() if chunk.node_kinds is not None else {}
    prog = {"loss": [float(m["L_vae"]) for m in watch.metrics],
            "mmd": float(watch.metrics[-1]["L_wae_mmd"])}
    e2e = {"train_seqs_per_s": steps * cfg.vae.batch_size / window_s,
           "setup_s": watch.t0 - run.t_start}
    ctx = {"config": run.config, "graph": graph, "traced": watch.traced,
           "batch": cfg.vae.batch_size, "steps": steps, "window_s": window_s}
    fed, first_grad, after3 = watch.fed, watch.first_grad, watch.after3
    corpus_rows = {tuple(r) for r in dataset.tokens.tolist()}
    del params, watch, chunk, dataset
    shutil.rmtree(out_dir, ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(run, device, fed, prog, first_grad, after3, corpus_rows)
    out = {"numbers": numbers, "attempted": 1, "failed": 0, "e2e": e2e,
           "ctx": ctx, "device": device_info(device, memory_peak)}
    if ctx["traced"]:
        w = ctx["traced"]["window"]
        out["device"].update(busy_s=w.busy_s(), window_s=w.window_s)
        out["breakdown"] = w.breakdown()
    return out


def _norm_gap(prog, ref, keep=None):
    """The largest per-leaf gap between the norms of ``prog`` and ``ref``
    ({leaf: tensor}), each against the larger of the reference leaf's norm
    and the median leaf's; ``keep`` the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    r = {k: float(ref[k].norm()) for k in names}
    med = statistics.median(r.values())
    return max(abs(float(prog[k].norm()) - r[k]) / max(r[k], med, 1e-30)
               for k in names)


def check(run, device, fed, prog, first_grad, after3, corpus_rows):
    """The compared numbers (gaps; larger is worse): loss_gap, mmd_gap,
    grad_gap, change_gap, and bad_rows, the batch rows that are no row of
    the corpus."""
    full_fp32()
    cfg = run.config
    texts = [torch.from_numpy(b).to(device).long() for f in fed for b in f]
    bad = sum(tuple(row) not in corpus_rows
              for f in fed for b in f for row in b.tolist())
    its = list(range(len(texts)))
    p0 = weights.make(cfg, run.seed, device)
    params = weights.clone(p0)
    out, g_ref = ref_train.run_steps(cfg, params, texts, its, run.seed)
    g_ref = {"/".join(map(str, k)): v for k, v in g_ref.items()}
    marks = [0, len(fed[1]), len(fed[1]) + len(fed[2])]
    loss_gap = max(abs(p - out[m][0]) / abs(out[m][0])
                   for p, m in zip(prog["loss"], marks))
    mmd_ref = out[marks[-1]][1]
    mmd_gap = abs(prog["mmd"] - mmd_ref) / max(abs(mmd_ref), 1e-30)
    grad_gap = _norm_gap(first_grad, g_ref)
    gn = {k: float(v.norm()) for k, v in g_ref.items()}
    med = statistics.median(gn.values())
    moving = {k for k, v in gn.items() if v >= 1e-3 * med}
    p0f, p3f = _flat(p0), _flat(params)
    change_gap = _norm_gap({k: after3[k] - p0f[k] for k in moving},
                           {k: p3f[k] - p0f[k] for k in moving})
    run.log(f"reference: {len(texts)} steps, losses "
            f"{[out[m][0] for m in marks]} against {prog['loss']}; "
            f"{len(gn) - len(moving)} leaves left out of the change")
    return {"loss_gap": loss_gap, "mmd_gap": mmd_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "bad_rows": float(bad)}
