"""The port's G1 arithmetic (zkp_subnet_tpu_torch/ops/curve.py) against the
JAX package's curve.py and the bigint oracle.

Points have known discrete logs (built with the oracle from a numpy seed)
and cross as numpy (N, 3, 24) arrays. The port evaluates the same field-op
sequence as the JAX package, so add and double agree projectively, limb for
limb; the scalar multiplication and the sum are compared as affine points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp_subnet_tpu.ops import curve as jcv
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.models.srs import from_numpy_points, to_numpy_points
from zkp_subnet_tpu_torch.ops import curve as tcv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G = o.G1.from_affine(o.G1_GEN)


def _dlogs(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % (o.R - 1) + 1
            for _ in range(n)]


def _points(dlogs):
    return tcv.g1_encode([o.G1.mul(G, d) for d in dlogs])


def _affine(pts):
    return tcv.g1_affine(pts)


@pytest.fixture(scope="module")
def jax_add_double():
    return jax.jit(jcv.g1_add), jax.jit(jcv.g1_double)


def test_add_double_match_jax_and_oracle(jax_add_double):
    jadd, jdbl = jax_add_double
    d = _dlogs(8, 11)
    p = _points(d)
    # general projective inputs: one doubling so Z ≠ 1
    p = tcv.g1_double(p)
    q = torch.roll(p, 1, dims=0)
    jp, jq = jnp.asarray(to_numpy_points(p)), jnp.asarray(to_numpy_points(q))
    got = tcv.g1_add(p, q)
    assert np.array_equal(to_numpy_points(got), np.asarray(jadd(jp, jq)))
    dd = [2 * x for x in d]
    assert _affine(got) == [o.G1.to_affine(o.G1.mul(G, a + b))
                            for a, b in zip(dd, dd[-1:] + dd[:-1])]
    got = tcv.g1_double(p)
    assert np.array_equal(to_numpy_points(got), np.asarray(jdbl(jp)))
    assert _affine(got) == [o.G1.to_affine(o.G1.mul(G, 2 * a)) for a in dd]


def test_add_edges_match_jax(jax_add_double):
    """Complete-formula edges (tests/test_lane8.py:116-131): P+∞, ∞+P,
    P+(−P), P+P and ∞+∞, projectively equal to the JAX package's result."""
    jadd, jdbl = jax_add_double
    p = _points(_dlogs(4, 12))
    inf = tcv.g1_infinity((4,))
    neg = tcv.g1_neg(p)
    for a, b in ((p, inf), (inf, p), (p, neg), (p, p), (inf, inf)):
        got = tcv.g1_add(a, b)
        want = jadd(jnp.asarray(to_numpy_points(a)),
                    jnp.asarray(to_numpy_points(b)))
        assert np.array_equal(to_numpy_points(got), np.asarray(want))
    assert all(pt is None for pt in _affine(tcv.g1_add(p, neg)))
    assert all(pt is None for pt in _affine(tcv.g1_double(inf)))
    assert np.array_equal(
        to_numpy_points(tcv.g1_double(inf)),
        np.asarray(jdbl(jnp.asarray(to_numpy_points(inf)))))


def test_infinity_and_encoding_match_jax():
    assert np.array_equal(to_numpy_points(tcv.g1_infinity((3,))),
                          np.asarray(jcv.g1_infinity((3,))))
    pts = [o.G1.mul(G, d) for d in _dlogs(5, 13)] + [o.G1.infinity()]
    t = tcv.g1_encode(pts)
    assert np.array_equal(to_numpy_points(t), np.asarray(jcv.g1_encode(pts)))
    assert torch.equal(from_numpy_points(to_numpy_points(t)), t)
    assert _affine(t) == [o.G1.to_affine(p) for p in pts]


def test_scalar_mul_matches_oracle():
    """k ∈ {0, 1, random, r − 1} against the oracle."""
    d = _dlogs(4, 14)
    ks = [0, 1, _dlogs(1, 15)[0], o.R - 1]
    got = tcv.g1_scalar_mul(_points(d), tcv.fr_to_scalar_limbs(ks))
    assert _affine(got) == [o.G1.to_affine(o.G1.mul(G, a * k % o.R))
                            for a, k in zip(d, ks)]


def test_fixed_base_tables_match_jax():
    """tables[j, d] = [d·2^(8j)]G, limb for limb the JAX package's, at a few
    (j, d), and as affine points against the oracle."""
    t = tcv.g1_fixed_base_tables()
    jt = np.asarray(jcv.g1_fixed_base_tables())
    assert t.shape == (32, 256, 3, 12) and jt.shape == (32, 256, 3, 24)
    for j, d in ((0, 0), (0, 1), (0, 255), (1, 1), (7, 100), (31, 255)):
        assert np.array_equal(to_numpy_points(t[j, d]), jt[j, d]), (j, d)
        assert _affine(t[j, d]) == [o.G1.to_affine(
            o.G1.mul(G, d << (8 * j)))]
    assert tcv.g1_fixed_base_tables() is t            # built once


def test_fixed_base_mul_matches_oracle_and_jax():
    """[k]G for k ∈ {0, 1, r − 1, random} against the oracle, and the
    projective result limb for limb against the JAX package's comb."""
    ks = [0, 1, o.R - 1] + _dlogs(5, 17)
    sc = tcv.fr_to_scalar_limbs(ks)
    got = tcv.g1_fixed_base_mul(tcv.g1_fixed_base_tables(), sc)
    assert _affine(got) == [o.G1.to_affine(o.G1.mul(G, k)) for k in ks]
    want = jcv.g1_fixed_base_mul(jcv.g1_fixed_base_tables(),
                                 jcv.fr_to_scalar_limbs(ks))
    assert np.array_equal(to_numpy_points(got), np.asarray(want))
    assert _affine(tcv.g1_neg(got)) == [o.G1.to_affine(o.G1.neg(
        o.G1.mul(G, k))) for k in ks]


def test_sum_select_matches_oracle():
    d = _dlogs(5, 16)                       # not a power of two: pads
    p = _points(d)
    assert _affine(tcv.g1_sum(p)[None]) == [
        o.G1.to_affine(o.G1.mul(G, sum(d) % o.R))]
    inf = tcv.g1_infinity((5,))
    cond = torch.tensor([True, False, True, False, False])
    sel = tcv.g1_select(cond, p, inf)
    assert [a is None for a in _affine(sel)] == [False, True, False, True,
                                                 True]
