"""B3's share of its roofline: its launches in the traced window times the
least time of one at the round's batch (counts.b3_bound_ms), over their
device time. Nothing when the trace holds no B3 launch."""

from portbench import counts


def read(ctx):
    traced = ctx.get("traced", {})
    if "window" not in traced:
        return None
    n, seconds = traced["window"].kernel_time("tfm_beam_kernel")
    if n == 0 or seconds <= 0:
        return None
    c = ctx["config"]
    bound_ms = counts.b3_bound_ms(ctx["round_size"], T=c["max_seq_len"],
                                  L=c["n_layers"], D=c["d_model"], F=c["d_ff"],
                                  V=c["n_vocab"], S=c["max_seq_len"] + 1)
    return 100.0 * n * bound_ms / 1e3 / seconds
