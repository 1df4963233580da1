"""A bounded profiler window and what the harness reads from it: the
device's busy time (the union of its kernels' and copies' intervals),
each kernel's time, and the idle gaps labelled by the host operation that
was running through them."""

import heapq
import time
from collections import defaultdict

# the profiler's own work on the host (CUPTI's buffer flushes and
# requests): device time left idle while one runs is the profiler's
PROFILER_HOST_OPS = ("Buffer Flush", "Activity Buffer Request")


def union_us(intervals):
    """Total length of the union of [start, end] intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def overlap_us(spans, intervals):
    """Length of the parts of disjoint sorted ``spans`` that lie inside
    the union of ``intervals``."""
    total, j = 0.0, 0
    cover = busy_spans(intervals)
    for s, e in spans:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < e:
            total += min(e, cover[k][1]) - max(s, cover[k][0])
            k += 1
    return total


def warm(host=True):
    """Start and stop the profiler once (its first start in a process
    takes seconds), so that a traced window does not pay for it."""
    import torch
    with Window(host):
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)


def busy_spans(intervals):
    """The union of [start, end] intervals as disjoint sorted spans."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Window:
    """``with Window() as w:`` profiles CUDA activity, and with ``host`` the
    operations of every host thread too; after the block, ``w.kernels``
    holds (name, start_us, end_us) of every device event, ``w.host`` (name,
    start_us, end_us) of every host event (without ``host``, only the CUDA
    runtime's calls), ``w.window_s`` the block's length on the host clock
    and ``w.t0_us``, ``w.t1_us`` its ends on the profiler's clock."""

    def __init__(self, host=True):
        self.record_host = host
        self.kernels, self.host = [], []
        self.window_s = 0.0
        self.t0_us = self.t1_us = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._cuda = torch.cuda.is_available()
        host = self.record_host or not self._cuda
        acts = [ProfilerActivity.CPU] if host else []
        if self._cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        cfg = None
        if host:
            try:
                # the work runs in other threads (the server's worker and
                # its clients): record every thread's operations
                from torch._C._profiler import _ExperimentalConfig
                cfg = _ExperimentalConfig(profile_all_threads=True)
            except TypeError:
                pass
        self._prof = profile(activities=acts, experimental_config=cfg)
        self._prof.__enter__()
        self._mark = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        if self._cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._mark
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        # the raw kineto events: building the profiler's event tree for
        # hundreds of thousands of kernels would take minutes
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            s = e.start_ns() / 1e3
            span = (e.name(), s, s + e.duration_ns() / 1e3)
            (self.kernels if e.device_type() == cuda else self.host).append(span)
        starts = [s for _, s, _ in self.kernels + self.host]
        ends = [t for _, _, t in self.kernels + self.host]
        if starts:
            # the window on the profiler's clock: its events' extent,
            # widened to the host clock's length where that is longer
            self.t0_us, self.t1_us = min(starts), max(ends)
            self.t1_us = max(self.t1_us, self.t0_us + 1e6 * self.window_s)
        return False

    def busy_s(self):
        return union_us([(s, e) for _, s, e in self.kernels]) / 1e6

    def idle_gaps(self):
        """The window's spans in which no device operation ran."""
        spans = busy_spans([(s, e) for _, s, e in self.kernels])
        edges = [self.t0_us] + [x for sp in spans for x in sp] + [self.t1_us]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def profiler_idle_s(self):
        """Seconds of the device's idle time in which the profiler's own
        host work (``PROFILER_HOST_OPS``) was running."""
        ops = [(s, e) for n, s, e in self.host if n in PROFILER_HOST_OPS]
        return overlap_us(self.idle_gaps(), ops) / 1e6

    def idle_share(self):
        """The device's idle share of the window in %, the time the
        profiler's own host work held it idle left out of both the idle
        time and the window."""
        if self.window_s <= 0:
            return None
        held = self.profiler_idle_s()
        idle = max(self.window_s - self.busy_s() - held, 0.0)
        return 100.0 * idle / (self.window_s - held)

    def kernel_time(self, match):
        """(launches, seconds) of the device events whose name contains
        ``match``."""
        hits = [e - s for n, s, e in self.kernels if match in n]
        return len(hits), sum(hits) / 1e6

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation around each gap's middle."""
        per_op = defaultdict(float)
        for n, s, e in self.kernels:
            per_op[n] += (e - s) / 1e6
        gaps = self.idle_gaps()
        host = sorted(self.host, key=lambda h: h[1])
        per_gap = defaultdict(float)
        active, i = [], 0
        for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], i))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            around = [host[j] for _, j in active]
            name = (min(around, key=lambda h: h[2] - h[1])[0] if around
                    else "no host operation")
            per_gap[name] += (e - s) / 1e6
        order = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        gaps_top = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in order],
                "idle_gaps": [[n, v] for n, v in gaps_top]}
