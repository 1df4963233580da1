"""The yardstick's arithmetic: the card's published peaks, the least time
of each hand-written kernel at its shapes (its roofline bound), and the
model FLOPs of a train step and of a CLaSS round.

A bound counts each input byte read once and each output byte written
once, and the operations the shapes need; the least time is the larger of
operations over the peak rate and bytes over the HBM rate. A roofline
share is that least time over the kernel's measured time, so it cannot
pass 100% while the count is right.
"""

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
FP32_PEAK = 67e12        # FLOP/s, outside the tensor cores
HBM_RATE = 3.35e12       # bytes/s


def _least_ms(flops, nbytes):
    return 1e3 * max(flops / FP32_PEAK, nbytes / HBM_RATE)


def b3_flops(B, T, K, L, D, F, V):
    """The transformer beam scan's FLOP at batch B: per beam token the
    products 2 L (3 D^2 + D^2 + 2 D F) + 2 D V, and attention's 4 D (t + 2)
    a layer at step t (the prefix and t + 1 tokens)."""
    per_tok = 2 * L * (3 * D * D + D * D + 2 * D * F) + 2 * D * V
    return B * K * sum(per_tok + L * 4 * D * (t + 2) for t in range(T))


def b3_bound_ms(B, T=25, K=5, L=2, D=128, F=256, V=24, S=26):
    """Least time of the float32 transformer beam scan (B3) at batch B: its
    FLOP over the fp32 peak against its inputs (the blocks' weights, the
    token and position tables, the final LayerNorm and head, the prefix's
    K and V rows) read once and its tapes written once."""
    words = (L * (3 * D * D + 3 * D + D * D + D + 2 * D * F + F + D)
             + V * D + S * D + 2 * L * B * D + L * 4 * D + 2 * D + D * V + V)
    n_out = 3 * B * T * K + B * K + 2 * B
    return _least_ms(b3_flops(B, T, K, L, D, F, V), 4 * (words + n_out))


def b2_bound_ms(kind, T, B, H):
    """Least time of a float32 B2 kernel: ``fwd`` the scan with its residual
    tape (the recurrent product, gi, wh, bh, h0 in, hs and the tape [T, B,
    H, 4] out), ``bwd`` its backward (as many FLOP; wh, h0, hs, the tape,
    dhs in; dgi, dghn, dh0 out), ``wgrad`` the weight gradient (h_{t-1}^T
    dgh over T B rows, h0, hs, dgi, dghn in; dwh, dbh out)."""
    tb, g3 = T * B, 3 * H
    if kind == "fwd":
        flops = 2 * tb * H * g3
        words = tb * g3 + H * g3 + g3 + B * H + tb * H + tb * 4 * H
    elif kind == "bwd":
        flops = 2 * tb * H * g3
        words = (H * g3 + B * H + tb * H + tb * 4 * H + tb * H + tb * g3
                 + tb * H + B * H)
    elif kind == "wgrad":
        flops = 2 * tb * (H + 1) * g3
        words = B * H + tb * H + tb * g3 + tb * H + H * g3 + g3
    else:
        raise ValueError(f"unknown B2 kernel {kind!r}")
    return _least_ms(flops, 4 * words)


def b5_bound_ms(kind, N, D):
    """Least time of B5 on z1, z2 [N, D]: the value's three distances a
    pair (9 N^2 D FLOP) or the gradient's (12 N^2 D), against z1, z2 read
    once (and the gradient written once)."""
    flops = (9 if kind == "fwd" else 12) * N * N * D
    words = 2 * N * D + 1 + (N * D if kind == "bwd" else 0)
    return _least_ms(flops, 4 * words)


def _gru_flops(n_in, H):
    """One GRU step's product FLOP for one row: input and recurrent."""
    return 2 * 3 * H * (n_in + H)


def forward_flops(cfg, B):
    """Matrix-product FLOP of one phase-1 forward over B rows: encoder,
    the mu and logvar heads, the teacher-forced decoder and its head, and
    the random features of the batch and of its prior sample."""
    T, E, Z, C, V = (cfg["max_seq_len"], cfg["emb_dim"], cfg["z_dim"],
                     cfg["c_dim"], cfg["n_vocab"])
    rf = 2 * 2 * Z * cfg["rf_dim"]
    if cfg["family"] == "gru":
        He, Hd = cfg["enc_h_dim"], Z + C
        enc = 2 * T * _gru_flops(E, He) + 2 * 2 * 2 * He * Z
        dec = T * (_gru_flops(E + Hd, Hd) + 2 * Hd * V)
        return B * (enc + dec + rf)
    D, L, F = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]

    def blocks(S, pairs):
        return L * (S * 2 * D * (3 * D + D + 2 * F) + 2 * 2 * D * pairs)

    S = T + 1
    enc = T * 2 * E * D + blocks(T, T * T) + 2 * 2 * D * Z
    dec = (T * 2 * E * D + 2 * (Z + C) * D + blocks(S, S * (S + 1) // 2)
           + T * 2 * D * V)
    return B * (enc + dec + rf)


def train_step_flops(cfg, B):
    """A phase-1 step: the forward and its backward (twice the forward's
    products), and B5's value on the batch's z."""
    return 3 * forward_flops(cfg, B) + 9 * B * B * cfg["z_dim"]


def round_flops(cfg, n, K=5):
    """A CLaSS round of n candidates, every one decoded: the heads' scores,
    the latent prefix through the decoder's blocks, and the beam scan."""
    Z, C, V, T = cfg["z_dim"], cfg["c_dim"], cfg["n_vocab"], cfg["max_seq_len"]
    heads = 2 * n * 2 * Z
    if cfg["family"] == "gru":
        H = Z + C
        return heads + n * K * T * (_gru_flops(cfg["emb_dim"] + H, H)
                                    + 2 * H * V)
    D, L, F = cfg["d_model"], cfg["n_layers"], cfg["d_ff"]
    prefix = n * (2 * (Z + C) * D + L * 2 * D * (3 * D + D + 2 * F))
    return heads + prefix + b3_flops(n, T, K, L, D, F, V)
