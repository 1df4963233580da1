"""The GRU scan kernels' share of their roofline in the traced window:
the least times of B2's forward (with its residual tape), backward and
weight gradient launches (counts.b2_bound_ms: per step two encoder scans
at the encoder's width and one decoder scan at z + c), over their device
time. Nothing when the trace holds no B2 launch."""

from portbench import counts

KERNELS = {"fwd": "gru_scan_kernel", "bwd": "gru_bwd_kernel",
           "wgrad": "gru_wgrad_kernel"}


def read(ctx):
    w = ctx.get("traced", {}).get("window")
    c = ctx["config"]
    if w is None or c["family"] != "gru":
        return None
    T, B = c["max_seq_len"], ctx["batch"]
    He, Hd = c["enc_h_dim"], c["z_dim"] + c["c_dim"]
    bound_s = seconds = 0.0
    for kind, name in KERNELS.items():
        n, s = w.kernel_time(name)
        per_scan = (2 * counts.b2_bound_ms(kind, T, B, He)
                    + counts.b2_bound_ms(kind, T, B, Hd)) / 3.0
        bound_s += n * per_scan / 1e3
        seconds += s
    return 100.0 * bound_s / seconds if seconds > 0 else None
