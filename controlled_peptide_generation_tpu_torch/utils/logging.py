"""Metric logger: an in-memory ``{it: {name: value}}`` record exported as
result.json, mirrored to TensorBoard event files when tensorboard is
installed.

* ``MetricLogger(logdir, json_fn)`` resumes (appends to) an existing
  result.json when ``json_fn`` names one;
* steps must be logged in order;
* ``export_to_json`` writes the ordered list of per-iteration dicts.

``DeferredFetch`` queues per-boundary metrics that still live on the
device and copies them to the host in one transfer per flush (the span
``train.fetch``).
"""

import json
import logging
import os

import torch

from . import tracing

LOG = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, logdir, json_fn=None, flush_secs=2):
        self.logdir = logdir
        self._log_dic = {}
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                LOG.info("tensorboard is not installed; metrics go to "
                         "result.json only")
            else:
                self._tb = SummaryWriter(logdir, flush_secs=flush_secs)
        if json_fn and os.path.exists(json_fn):
            try:
                with open(json_fn) as fh:
                    self._log_dic.update({e["it"]: e for e in json.load(fh)})
            except json.JSONDecodeError as e:
                LOG.warning("could not decode %s: %s", json_fn, e)

    def log_value(self, name, value, step):
        if self._log_dic and step < max(self._log_dic):
            raise ValueError(f"logging into the past: {step} < "
                             f"{max(self._log_dic)}")
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), global_step=step)
        self._log_dic.setdefault(step, {"it": step})
        self._log_dic[step][name] = float(value)

    def get_logged_values(self, step):
        return self._log_dic[step]

    def get_last_logged_values(self):
        if not self._log_dic:
            return {}
        return self.get_logged_values(max(self._log_dic))

    def export_to_json(self, json_fn, it_filter=lambda k, v: True,
                       write_empty=False):
        rows = [self._log_dic[it] for it in sorted(self._log_dic)
                if it_filter(it, self._log_dic[it])]
        if rows or write_empty:
            with open(json_fn, "w") as fh:
                json.dump(rows, fh, indent=1)

    def close(self):
        if self._tb is not None:
            self._tb.close()


class DeferredFetch:
    """Queue (meta, {name: 0-d tensor}, *extra tensors) entries and copy
    them to the host together: one stacked transfer per flush instead of
    a device sync per value. ``sink(meta, {name: float}, *extras_numpy)``
    is called per entry at flush time, in order."""

    def __init__(self, flush_every, sink):
        self.flush_every = max(int(flush_every), 1)
        self.sink = sink
        self.pending = []

    def add(self, meta, scalars, *extras, force=False):
        self.pending.append((meta, scalars, extras))
        if force or len(self.pending) >= self.flush_every:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        with tracing.span("train.fetch"):
            korder = sorted(self.pending[0][1])
            rows = torch.stack([
                torch.stack([torch.as_tensor(m[k]).float().reshape(())
                             .to(self._device(m)) for k in korder])
                for _, m, _ in self.pending]).cpu().numpy()
            extras = [torch.stack([e[i] for _, _, e in self.pending]).cpu()
                      .numpy() for i in range(len(self.pending[0][2]))]
            for j, (meta, _, _) in enumerate(self.pending):
                vals = dict(zip(korder, map(float, rows[j])))
                self.sink(meta, vals, *(ex[j] for ex in extras))
            self.pending.clear()

    @staticmethod
    def _device(scalars):
        for v in scalars.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")
