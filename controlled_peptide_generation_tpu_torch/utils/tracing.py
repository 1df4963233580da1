"""Spans and counters inside the port, and the bounded ``--hw.profile_dir``
trace.

* Counters are always on. ``counter(name)`` is a named count and sum in
  the process-wide registry (``snapshot()`` reads them all); a
  ``Histogram`` is a log-bucketed distribution kept by the object it
  measures (the server's queue wait, in its ``stats_snapshot()``).
* Host spans. ``span(name, counter=None, **ids)`` records its name, start,
  end, its own id, the id of the span open on the same thread (its parent)
  and the ids passed in (a round, a step ``it``) into a bounded buffer
  (``spans()``), but only while a ``torch.profiler`` session records or
  ``enable()`` is in force; otherwise it is one flag check and returns a
  shared no-op (with a ``counter``, a pair of ``perf_counter`` calls that
  add the span's seconds to it). Times are Unix-epoch nanoseconds
  (``time.time_ns()``), the clock of the profiler's events: kineto
  converts its own clock to it, so a span lines up with the profiler's
  host and device events. While a profiler records, a span also opens a
  ``record_function`` range of its name (its fast form), so the
  profiler's Chrome traces carry the spans.
* Device spans. ``device_span(device)`` records a timing event on the
  device's current stream before some work, ``DeviceSpan.end()`` one after
  it; ``DeviceTimes`` sums the spans of one stream and the gaps between
  one span's end and the next one's start, reading a span only once its
  end event has completed (``query()``), so they add no synchronisation.
"""

import contextlib
import itertools
import logging
import math
import threading
import time
from collections import deque, namedtuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import (ProfilerActivity, profile, schedule,
                            tensorboard_trace_handler)

log = logging.getLogger(__name__)

MAX_SPANS = 1 << 16     # the buffer keeps the newest spans
# --hw.profile_dir's window, in the loop's boundaries (a step or a chunk
# each): step 0 and the first chunk (its CUDA graph's capture) pass
# untraced, the next boundary warms the profiler up, the two after it are
# recorded: two chunks and the boundary between them (three 50-step
# chunks made 110 MB of trace at the GRU configuration and 317 MB at the
# transformer's on an H100)
PROFILE_SCHEDULE = dict(wait=2, warmup=1, active=2, repeat=1)

Span = namedtuple("Span", "name start_ns end_ns id parent thread ids")

_forced = False
_spans = deque(maxlen=MAX_SPANS)
_next_id = itertools.count(1)
_open = threading.local()       # each thread's stack of open span ids
_counters = {}
_counters_lock = threading.Lock()


# -- counters ----------------------------------------------------------------

class Counter:
    """A count and a sum (seconds, where it times something)."""

    __slots__ = ("count", "sum")

    def __init__(self):
        self.count, self.sum = 0, 0.0

    def add(self, value):
        self.count += 1
        self.sum += value


def counter(name):
    """The registry's counter ``name``, made at its first use."""
    with _counters_lock:
        return _counters.setdefault(name, Counter())


def snapshot():
    """{name: {"count", "sum"}} of every counter in the registry."""
    with _counters_lock:
        return {k: {"count": c.count, "sum": c.sum}
                for k, c in _counters.items()}


class Histogram:
    """Counts of values (seconds) in log-spaced buckets, each ``growth``
    times as wide as the one below: bucket 0 holds [0, lo), bucket i
    [lo * growth^(i-1), lo * growth^i), the last the values from ``hi``
    up and those added by ``add_overflow()`` (a request that failed
    before its first row). The caller serialises ``add``."""

    def __init__(self, lo=1e-5, hi=1e3, growth=1.05):
        self.lo, self.growth = lo, growth
        self._log_g = math.log(growth)
        self.n = math.ceil(math.log(hi / lo) / self._log_g)
        self.counts = [0] * (self.n + 2)

    def add(self, x):
        i = 0 if x < self.lo else min(
            int(math.log(x / self.lo) / self._log_g) + 1, self.n + 1)
        self.counts[i] += 1

    def add_overflow(self):
        self.counts[-1] += 1

    def snapshot(self):
        """A plain dict (JSON, deep copies): its bucket counts and their
        spacing, for ``percentile``."""
        return {"lo": self.lo, "growth": self.growth,
                "counts": list(self.counts)}

    @staticmethod
    def percentile(snap, q, base=None):
        """The q-th percentile (0-100) of a snapshot's values, less those
        of an earlier snapshot ``base`` of the same histogram, interpolated
        linearly within its bucket; inf where it falls in the overflow
        bucket, None without values."""
        counts = snap["counts"]
        if base is not None:
            counts = [a - b for a, b in zip(counts, base["counts"])]
        total = sum(counts)
        if total <= 0:
            return None
        rank, below = q / 100.0 * total, 0
        for i, c in enumerate(counts):
            if c and below + c >= rank:
                break
            below += c
        if i == len(counts) - 1:
            return math.inf
        lo, g = snap["lo"], snap["growth"]
        left = 0.0 if i == 0 else lo * g ** (i - 1)
        right = lo * g ** i
        return left + (right - left) * max(rank - below, 0.0) / c


# -- host spans --------------------------------------------------------------

def enable(on=True):
    """Record spans whether or not a profiler runs (``on``), or only while
    one does (the default)."""
    global _forced
    _forced = bool(on)


def spans(name=None):
    """The recorded spans (``Span``: name, start_ns, end_ns, id, parent,
    thread, ids), oldest first; with ``name`` those of that name."""
    out = list(_spans)
    return out if name is None else [s for s in out if s.name == name]


def clear():
    """Drop every recorded span."""
    _spans.clear()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Timed:
    """A span that is not recorded: its seconds go to its counter."""

    __slots__ = ("counter", "t0")

    def __init__(self, counter_):
        self.counter = counter_

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.counter.add(time.perf_counter() - self.t0)
        return False


class _Span:
    __slots__ = ("name", "counter", "ids", "id", "parent", "range", "t0",
                 "start")

    def __init__(self, name, counter_, ids):
        self.name, self.counter, self.ids = name, counter_, ids

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_next_id)
        stack.append(self.id)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            # record_function's range, without its operator dispatch (some
            # 10-50 us under the profiler, which would part the span's
            # ends from the range's)
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        # inside the range: the span lies within what the trace shows
        self.t0 = time.perf_counter()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.counter is not None:
            self.counter.add(time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _open.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.id, self.parent,
                           threading.get_ident(), self.ids))
        return False


def span(name, counter=None, **ids):
    """A host span ``with span(...):`` (see the module's doc); its seconds
    go to ``counter`` (a ``Counter``) whether or not it is recorded."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        return _Span(name, counter, ids)
    return _NO_SPAN if counter is None else _Timed(counter)


# -- device spans ------------------------------------------------------------

class DeviceSpan:
    """Timing events on one device's current stream around the work
    enqueued between them; ``synchronize()`` waits for the end."""

    __slots__ = ("device", "start", "stop")

    def __init__(self, device):
        self.device = device
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(device))
        self.stop = None

    def end(self):
        self.stop = torch.cuda.Event(enable_timing=True)
        self.stop.record(torch.cuda.current_stream(self.device))
        return self

    def synchronize(self):
        self.stop.synchronize()


def device_span(device):
    """A ``DeviceSpan`` started on ``device``; None off CUDA."""
    device = torch.device(device)
    return DeviceSpan(device) if device.type == "cuda" else None


class DeviceTimes:
    """Device seconds of one stream's ended ``DeviceSpan``s (``device_s``,
    ``spans``) and of the gaps from one's end to the next one's start
    (``gap_s``, ``gaps``), added in stream order. A span is read once its
    end event has completed."""

    def __init__(self):
        self.device_s = self.gap_s = 0.0
        self.spans = self.gaps = 0
        self._pending = deque()
        self._last = None

    def add(self, span_):
        self._pending.append(span_)
        self.poll()

    def poll(self):
        """Read the ended spans whose end has completed, oldest first."""
        while self._pending and self._pending[0].stop.query():
            s = self._pending.popleft()
            self.device_s += s.start.elapsed_time(s.stop) / 1e3
            self.spans += 1
            if self._last is not None:
                self.gap_s += self._last.elapsed_time(s.start) / 1e3
                self.gaps += 1
            self._last = s.stop

    def restart(self):
        """Forget the unread spans and the last end (work between them
        was dropped: no gap is read across it)."""
        self._pending.clear()
        self._last = None


# -- the bounded profiler window (--hw.profile_dir) --------------------------

def _no_step():
    pass


@contextlib.contextmanager
def trace(logdir):
    """A torch.profiler trace (CPU and CUDA activities) of a loop's window
    ``PROFILE_SCHEDULE``, written into ``logdir`` as a Chrome trace
    (``<worker>.<ms>.pt.trace.json``, which TensorBoard's profiler plugin
    and Perfetto read) once the window closes or the block ends. Yields
    the function the loop calls at each of its boundaries; without a
    directory, or where the profiler cannot start (a warning is logged),
    the block runs untraced."""
    if not logdir:
        yield _no_step
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   schedule=schedule(**PROFILE_SCHEDULE),
                   on_trace_ready=tensorboard_trace_handler(logdir))
    try:
        prof.start()
    except RuntimeError as e:
        log.warning("profiler unavailable: %s", e)
        yield _no_step
        return
    first = PROFILE_SCHEDULE["wait"] + PROFILE_SCHEDULE["warmup"]
    log.info("torch.profiler trace of loop boundaries %d-%d -> %s", first,
             first + PROFILE_SCHEDULE["active"] - 1, logdir)
    try:
        yield prof.step
    finally:
        prof.stop()
