"""The whole round's share of the card's fp32 peak: the model FLOP of the
rounds decoded in the traced window (one B3 or B1 launch a round;
counts.round_flops) over the window and 67 TFLOP/s."""

from portbench import counts


def read(ctx):
    traced = ctx.get("traced", {})
    if "window" not in traced:
        return None
    w = traced["window"]
    kernel = ("tfm_beam_kernel" if ctx["config"]["family"] == "transformer"
              else "beam_gru")
    n, _ = w.kernel_time(kernel)
    if n == 0 or w.window_s <= 0:
        return None
    flops = n * counts.round_flops(ctx["config"], ctx["round_size"])
    return 100.0 * flops / w.window_s / counts.FP32_PEAK
