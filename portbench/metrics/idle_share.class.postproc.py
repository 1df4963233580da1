"""The share of the traced window, in %, in which the device was idle
while the server's worker ran its host work on a round (its
``serve.postproc`` spans: dedup, detokenisation, physicochemistry, row
dicts): the window's idle gaps intersected with those spans, less the
parts in which the profiler's own host work ran, over the window less the
time that work held the device idle, as ``idle_share.class`` counts it.
Nothing without a traced window holding device events, or without
spans."""

from portbench import trace


def _intersect(a, b):
    """The intersection of two lists of disjoint sorted intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(ctx):
    w = ctx.get("traced", {}).get("window")
    if w is None or not w.kernels or w.window_s <= 0:
        return None
    try:
        from controlled_peptide_generation_tpu_torch.utils import tracing
    except ImportError:
        return None
    post = trace.busy_spans([(s.start_ns / 1e3, s.end_ns / 1e3)
                             for s in tracing.spans("serve.postproc")])
    if not post:
        return None
    idle_post = _intersect(w.idle_gaps(), post)
    ops = [(s, e) for n, s, e in w.host if n in trace.PROFILER_HOST_OPS]
    us = (sum(e - s for s, e in idle_post)
          - trace.overlap_us(idle_post, ops))
    return 100.0 * us / 1e6 / (w.window_s - w.profiler_idle_s())
