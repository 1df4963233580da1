"""The device's idle share of the traced window, in %: 1 - the union of
its kernels' and copies' intervals over the window, with the idle time in
which the profiler's own host work ran (its buffer flushes) left out of
the idle time and the window alike (``trace.Window.idle_share``)."""


def read(ctx):
    w = ctx.get("traced", {}).get("window")
    return None if w is None else w.idle_share()
