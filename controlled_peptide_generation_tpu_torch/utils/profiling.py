"""Tracing and profiling hooks (the JAX package's ``utils/profiling.py``).

``trace`` is a ``torch.profiler`` trace around a hot loop (the phase-1
trainer's, under ``--hw.profile_dir``), CPU and CUDA activities, written
into the directory as a Chrome trace (``<worker>.<ms>.pt.trace.json``,
which TensorBoard's profiler plugin and Perfetto read); ``Throughput`` a
windowed items/s counter that can feed the metric logger; ``annotate`` a
named range in the trace.
"""

import contextlib
import logging
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """A torch.profiler trace around a block, written into ``logdir`` when
    the block ends; a no-op when disabled or without a directory. Where
    the profiler cannot start, a warning is logged and the block runs
    untraced, as the JAX package's trace does."""
    if not enabled or not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    try:
        prof.start()
    except RuntimeError as e:
        log.warning("profiler unavailable: %s", e)
        yield
        return
    log.info("torch.profiler trace -> %s", logdir)
    try:
        yield
    finally:
        prof.stop()


class Throughput:
    """Windowed items/sec counter; optionally mirrored into the logger."""

    def __init__(self, name, logger=None, log_every=100):
        self.name = name
        self.logger = logger
        self.log_every = log_every
        self.t0 = time.perf_counter()
        self.count = 0
        self.total = 0

    def add(self, n=1, step=None):
        """Count n items; at every ``log_every`` items return the window's
        rate (and log it as <name>_per_sec at ``step``), else None."""
        self.count += n
        self.total += n
        if self.log_every and self.count >= self.log_every:
            rate = self.rate()
            if self.logger is not None and step is not None:
                self.logger.log_value(self.name + "_per_sec", rate, step)
            self.reset()
            return rate
        return None

    def rate(self):
        dt = time.perf_counter() - self.t0
        return self.count / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.count = 0


def annotate(name):
    """A named range in profiler traces (``record_function``)."""
    return record_function(name)
