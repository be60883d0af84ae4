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


def test_from_mont_wide_matches_jax():
    coeffs = _row(256, 7)
    jc = JFR.encode(coeffs)
    got = tpoly.from_mont_wide(FR.from_limbs16(np.asarray(jc)))
    want = jax.jit(jpoly.from_mont_wide)(jc)
    assert np.array_equal(FR.to_limbs16(got), np.asarray(want))
    assert FR.limbs_to_ints(got) == coeffs
