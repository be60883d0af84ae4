"""The port's polynomial pipeline (zkp_subnet_tpu_torch/ops/poly.py) against
the reference golden vectors, the JAX package's poly.py and the oracle.

Rows and points come from a numpy seed; the comparison is on (N, 16) uint32
16-bit limbs (Montgomery for evaluations, canonical for quotient scalars).
Tolerance: none. x = 0 is covered: a commit-only request opens at x = 0.
"""

import jax
import numpy as np
import pytest
import torch

from test_golden import TEST_EVAL, TEST_POINT, TEST_POLY
from zkp_subnet_tpu.ops import poly as jpoly
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.utils import encoding as enc
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.ops import poly as tpoly
from zkp_subnet_tpu_torch.ops.field import FR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(n)]


def test_golden_eval_and_quotient():
    coeffs = enc.poly_from_b64(TEST_POLY)
    x = enc.fr_from_b64(TEST_POINT)
    y, q = tpoly.poly_eval_and_quotient(FR.encode(coeffs), FR.encode([x])[0])
    assert enc.fr_to_b64(FR.decode(y)[0]) == TEST_EVAL
    assert FR.decode(q) == o.poly_quotient(coeffs, x)
    assert enc.fr_to_b64(FR.decode(tpoly.poly_eval(
        FR.encode(coeffs), FR.encode([x])[0]))[0]) == TEST_EVAL


def test_quotient_at_zero_is_the_shifted_row():
    coeffs = _row(8, 1)
    y, q = tpoly.poly_eval_and_quotient(FR.encode(coeffs), FR.zeros(()))
    assert FR.decode(y) == [coeffs[0]]
    assert FR.decode(q) == coeffs[1:]


@pytest.fixture(scope="module")
def jax_open():
    return jax.jit(jpoly.poly_open_scalars)


@pytest.mark.parametrize("n", [16, 256])
def test_open_scalars_match_jax(jax_open, n):
    coeffs = _row(n, n)
    x = _row(1, n + 1)[0]
    jc = JFR.encode(coeffs)
    c = FR.from_limbs16(np.asarray(jc))
    for point in (x, 0):
        jy, jq = jax_open(jc, JFR.encode([point])[0])
        y, q = tpoly.poly_open_scalars(c, FR.encode([point])[0])
        assert np.array_equal(FR.to_limbs16(y), np.asarray(jy))
        assert np.array_equal(FR.to_limbs16(q), np.asarray(jq))
        want_q = (o.poly_quotient(coeffs, point) if point else coeffs[1:])
        assert FR.limbs_to_ints(q) == want_q + [0]
        assert FR.decode(y) == [o.poly_eval(coeffs, point)]


@pytest.mark.parametrize("n", [16, 256])
def test_open_pieces_plain_match_jax(jax_open, n):
    """The plain versions of the four opening kernels (fr_inv, fr_powers,
    fr_suffix_scan, fr_open_quotient), composed as the card runs them with
    tiles of 32 (one partial tile at 16, eight full ones at 256), against
    the JAX package's poly_open_scalars, limb for limb, at x random, 0, 1
    and r − 1; Montgomery quotients against poly_eval_and_quotient."""
    coeffs = _row(n, n + 2)
    jc = JFR.encode(coeffs)
    c = FR.from_limbs16(np.asarray(jc))
    for point in (_row(1, n + 3)[0], 0, 1, o.R - 1):
        x = FR.encode([point])[0]
        jy, jq = jax_open(jc, JFR.encode([point])[0])
        y, q = tpoly.open_pieces_plain(c, x, tile=32)
        assert np.array_equal(FR.to_limbs16(y), np.asarray(jy)), point
        assert np.array_equal(FR.to_limbs16(q), np.asarray(jq)), point
        wy, wq = tpoly.poly_eval_and_quotient(c, x)
        assert torch.equal(y, wy), point
        assert torch.equal(FR.to_mont(q[:-1]), wq), point
        assert FR.decode(q[-1:]) == [0]


def test_scan_plain_crosses_tiles():
    """fr_suffix_scan_plain's tiles and fr_open_quotient_plain's carry at a
    width that is no multiple of the tile (200 = 6 × 32 + 8), and a row of
    zeros: local sums and totals against Python's integers, the opening
    against the oracle and the CPU composition."""
    n, tile = 200, 32
    coeffs = _row(n, 9)
    c = FR.encode(coeffs)
    local, totals = tpoly.fr_suffix_scan_plain(c, tile)
    assert local.shape == (n, 8) and totals.shape == (7, 8)
    ends = [min(n, (j // tile + 1) * tile) for j in range(n)]
    assert FR.decode(local) == [sum(coeffs[j:e]) % o.R
                                for j, e in zip(range(n), ends)]
    assert FR.decode(totals) == [sum(coeffs[b:b + tile]) % o.R
                                 for b in range(0, n, tile)]
    for point in (_row(1, 10)[0], 0):
        x = FR.encode([point])[0]
        y, q = tpoly.open_pieces_plain(c, x, tile=tile)
        assert FR.decode(y) == [o.poly_eval(coeffs, point)]
        want = o.poly_quotient(coeffs, point) if point else coeffs[1:]
        assert FR.limbs_to_ints(q) == want + [0]
        wy, wq = tpoly.poly_open_scalars(c, x)
        assert torch.equal(y, wy) and torch.equal(q, wq)
    zeros = FR.zeros((n,))
    y, q = tpoly.open_pieces_plain(zeros, FR.encode([3])[0], tile=tile)
    assert not y.any() and not q.any()


def test_from_mont_wide_matches_jax():
    coeffs = _row(256, 7)
    jc = JFR.encode(coeffs)
    got = tpoly.from_mont_wide(FR.from_limbs16(np.asarray(jc)))
    want = jax.jit(jpoly.from_mont_wide)(jc)
    assert np.array_equal(FR.to_limbs16(got), np.asarray(want))
    assert FR.limbs_to_ints(got) == coeffs
