"""The roofline counts on small shapes, against counts made by hand."""

import math

from benchmark.roofline import fr_open, msm, ntt, peaks


def test_pippenger_takes_the_cheapest_window():
    # n = 4 points, 8-bit scalars: c = 1 .. 8 windows of n bucket adds, a
    # running sum of 2 (2^c - 1) adds and one add into the total, and
    # 8 - c doubles
    def ops(c):
        w = math.ceil(8 / c)
        return (w * (4 + 2 * (2 ** c - 1) + 1) * peaks.OPS_G1_ADD
                + (8 - c) * peaks.OPS_G1_DOUBLE)
    assert msm.pippenger_ops(4, 8) == min(ops(c) for c in range(1, 9))


def test_pippenger_at_the_mainnet_row_uses_a_12_bit_window():
    n = 1 << 16
    c = 12
    want = (math.ceil(255 / c) * (n + 2 * (2 ** c - 1) + 1)
            * peaks.OPS_G1_ADD + (255 - c) * peaks.OPS_G1_DOUBLE)
    assert msm.pippenger_ops(n) == want


def test_round_work_counts_rows_and_the_aggregation():
    shape = {"rows_local": 4, "row": 8, "workers": 4}
    ops, nbytes = msm.round_work(shape)
    assert ops == (8 * msm.pippenger_ops(8) + 2 * msm.pippenger_ops(4)
                   + 2 * 3 * peaks.OPS_G1_ADD)
    assert nbytes == (4 * 8 * 144 + 8 * (8 * 32 + 144)
                      + 4 * 144 + 2 * (4 * 32 + 144) + 2 * 5 * 144)
    assert fr_open.round_work(shape) == (
        32 * (peaks.OPS_FR_MUL + peaks.OPS_FR_LIN), 2 * 32 * 32)


def test_ntt_counts_twiddles_other_than_one():
    # T = 8: stages of half 1, 2, 4 have 0, 2, 3 twiddles other than 1 in
    # 4 butterflies each: 0 + 2 + 3 = 5 products, 8 for 1/T, 24 add/subs
    shape = {"rows_local": 3, "row": 8, "workers": 4}
    assert ntt.round_work(shape) == (
        3 * ((5 + 8) * peaks.OPS_FR_MUL + 24 * peaks.OPS_FR_LIN),
        3 * 2 * 8 * 32)


def test_bound_is_the_larger_of_bytes_and_operations():
    rate = 64 * 132 * 1980e6
    assert peaks.bound_s(3.35e12, 0, rate) == 1.0
    assert peaks.bound_s(0, rate, rate) == 1.0
    assert peaks.OPS_G1_ADD == 4104 and peaks.OPS_G1_DOUBLE == 2484


def test_a_rounds_challenges_multiply_all_but_the_bases_and_keys():
    one = {"rows_local": 4, "row": 8, "workers": 4}
    two = dict(one, batch=2)
    ops1, bytes1 = msm.round_work(one)
    ops2, bytes2 = msm.round_work(two)
    assert ops2 == 2 * ops1
    assert bytes2 == 2 * bytes1 - (4 * 8 * 144 + 4 * 144)
    assert fr_open.round_work(two) == tuple(2 * v for v in
                                            fr_open.round_work(one))
    assert ntt.round_work(two) == tuple(2 * v for v in ntt.round_work(one))


def test_the_y_transform_counts_its_columns():
    # rows of T = 8 on M = 4 workers over 2 ranks: 4 columns of 4 points a
    # rank; 4 points: 4 twiddles other than 1 less 3, plus 4 for 1/n
    shape = {"rows_local": 2, "row": 8, "workers": 4, "machine_ranks": 2,
             "transforms": ["y"]}
    col = (2 * 2 - 3 + 4) * peaks.OPS_FR_MUL + 4 * 2 * peaks.OPS_FR_LIN
    assert ntt.transform_ops(4) == col
    assert ntt.round_work(shape) == (4 * col, 2 * 2 * 8 * 32)
    both = dict(shape, transforms=["x", "y"])
    assert ntt.round_work(both)[0] == 4 * col + 2 * ntt.transform_ops(8)
    assert ntt.round_work(dict(shape, transforms=[])) == (0, 0)
