"""Scalar schedules: a linear ramp clamped at both ends."""


def interpolate(start_val, end_val, start_iter, end_iter, current_iter):
    """Linear ramp from start_val to end_val between start_iter and
    end_iter, constant outside."""
    span = end_iter - start_iter
    if span <= 0:
        span = 1
    frac = min(max((current_iter - start_iter) / span, 0.0), 1.0)
    return start_val + (end_val - start_val) * frac


def anneal(sched, it):
    """Evaluate a {start: {val, iter}, end: {val, iter}} schedule at it."""
    return interpolate(sched.start.val, sched.end.val,
                       sched.start.iter, sched.end.iter, it)
