"""The yardstick's counts, pinned to the bounds of PERF.md's kernel table
(the least times ``chip_smoke.py`` computed for each kernel)."""

import pytest

from portbench import counts


@pytest.mark.parametrize("B, ms", [(5000, 5.0818), (2500, 2.5409)])
def test_b3_bound(B, ms):
    assert counts.b3_bound_ms(B) == pytest.approx(ms, rel=2e-4)


@pytest.mark.parametrize("kind, B, ms", [
    ("fwd", 32, 0.000821), ("bwd", 32, 0.001019), ("wgrad", 32, 0.000753),
    ("fwd", 1024, 0.025105), ("bwd", 1024, 0.031465),
    ("wgrad", 1024, 0.024085)])
def test_b2_bound(kind, B, ms):
    assert counts.b2_bound_ms(kind, 25, B, 102) == pytest.approx(ms, rel=1e-3)


@pytest.mark.parametrize("kind, N, ms", [
    ("fwd", 32, 0.000014), ("fwd", 4096, 0.225366),
    ("bwd", 32, 0.000018), ("bwd", 4096, 0.300487)])
def test_b5_bound(kind, N, ms):
    assert counts.b5_bound_ms(kind, N, 100) == pytest.approx(ms, rel=3e-2)


def test_b2_pair_bound():
    # PERF.md: the pair fwd + bwd at H 102 is bound by 0.001840 / 0.056570 ms
    for B, ms in ((32, 0.001840), (1024, 0.056570)):
        got = counts.b2_bound_ms("fwd", 25, B, 102) + counts.b2_bound_ms(
            "bwd", 25, B, 102)
        assert got == pytest.approx(ms, rel=1e-3)


GRU = {"family": "gru", "n_vocab": 24, "max_seq_len": 25, "z_dim": 100,
       "c_dim": 2, "emb_dim": 150, "enc_h_dim": 80, "rf_dim": 500}
TFM = {"family": "transformer", "n_vocab": 24, "max_seq_len": 25,
       "z_dim": 100, "c_dim": 2, "emb_dim": 150, "d_model": 128,
       "n_layers": 2, "d_ff": 256, "rf_dim": 500}


def test_train_step_flops():
    # a GRU step at batch 32 is about 1.07-1.09 GFLOP (PERF.md, bench.py's
    # count of the same products); the transformer's about three times more
    assert 1.0e9 < counts.train_step_flops(GRU, 32) < 1.15e9
    assert 2.5e9 < counts.train_step_flops(TFM, 32) < 3.5e9


def test_round_flops_cover_b3():
    n = 2688
    b3 = counts.b3_flops(n, 25, 5, 2, 128, 256, 24)
    total = counts.round_flops(TFM, n)
    assert b3 < total < 1.05 * b3
    # the B3 bound at this batch is operations-bound: its FLOP over the peak
    assert counts.b3_bound_ms(n) == pytest.approx(
        1e3 * b3 / counts.FP32_PEAK, rel=1e-9)
