"""The 95th percentile of the window's requests' queue wait inside the
server, in ms: ``generate()`` to the request's first row, from the
server's ``queue_wait`` histogram (``stats_snapshot()``), the window's
counts (after less before), interpolated within a bucket at most 5% wide.
Nothing without the histogram, or where the percentile falls among the
requests that failed before a first row."""

import math


def read(ctx):
    after, before = ctx["after"].get("queue_wait"), ctx["before"].get(
        "queue_wait")
    if after is None or before is None:
        return None
    try:
        from controlled_peptide_generation_tpu_torch.utils.tracing import (
            Histogram)
    except ImportError:
        return None
    p = Histogram.percentile(after, 95, before)
    return None if p is None or not math.isfinite(p) else 1e3 * p
