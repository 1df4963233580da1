"""The whole train step's share of the card's fp32 peak: the model FLOP
of the window's steps (counts.train_step_flops) over 67 TFLOP/s and the
window, on the host clock, with the profiler's stretch of a traced run
(its steps and its time, start and stop included) left out, so that the
profiler's cost does not read as the trainer's."""

from portbench import counts


def read(ctx):
    traced = ctx.get("traced", {})
    if not traced:
        return None
    steps = ctx["steps"] - traced["steps"]
    seconds = ctx["window_s"] - traced["wall_s"]
    if steps <= 0 or seconds <= 0:
        return None
    flops = steps * counts.train_step_flops(ctx["config"], ctx["batch"])
    return 100.0 * flops / seconds / counts.FP32_PEAK
