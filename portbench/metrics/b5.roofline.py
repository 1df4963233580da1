"""The MMD kernel's share of its roofline in the traced window: the least
times of B5's value and gradient launches on the batch's z
(counts.b5_bound_ms at N = batch, D = z), over their device time."""

from portbench import counts


def read(ctx):
    w = ctx.get("traced", {}).get("window")
    if w is None:
        return None
    N, D = ctx["batch"], ctx["config"]["z_dim"]
    bound_s = seconds = 0.0
    for kind, name in (("fwd", "mmd_fwd_kernel"), ("bwd", "mmd_grad_kernel")):
        n, s = w.kernel_time(name)
        bound_s += n * counts.b5_bound_ms(kind, N, D) / 1e3
        seconds += s
    return 100.0 * bound_s / seconds if seconds > 0 else None
