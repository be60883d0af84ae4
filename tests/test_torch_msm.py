"""The port's MSM (zkp_subnet_tpu_torch/ops/msm.py) against the known-dlog
oracle and the JAX package's Pippenger.

Bases are [a_i]G with a_i drawn from a numpy seed (tests/test_msm.py:22-34
builds them the same way), so the expected Σ k_i·P_i costs one oracle
multiplication. Outputs are compared as affine points.
"""

import jax
import numpy as np
import pytest
import torch

from zkp_subnet_tpu.ops import curve as jcv
from zkp_subnet_tpu.ops import msm as jmsm
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.models.srs import to_numpy_points
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops.field import FR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G = o.G1.from_affine(o.G1_GEN)


def _ints(n, rng, lo=0):
    return [int.from_bytes(rng.bytes(40), "little") % (o.R - lo) + lo
            for _ in range(n)]


def _instance(n, seed):
    """(points, dlogs, scalars) with points = [a_i]G built by consecutive
    oracle additions of a random step (cheap, and still of known dlog)."""
    rng = np.random.default_rng(seed)
    a, s = _ints(2, rng, lo=1)
    p, step, pts = o.G1.mul(G, a), o.G1.mul(G, s), []
    for _ in range(n):
        pts.append(p)
        p = o.G1.add(p, step)
    dlogs = [(a + i * s) % o.R for i in range(n)]
    return tcv.g1_encode(pts), dlogs, _ints(n, rng)


def _want(dlogs, ks):
    return o.G1.to_affine(o.G1.mul(G, sum(a * k for a, k in zip(dlogs, ks))
                                   % o.R))


def test_msm_256_matches_oracle_and_jax():
    pts, dlogs, ks = _instance(256, 1)
    sc = tcv.fr_to_scalar_limbs(ks)
    got = tcv.g1_affine(tmsm.msm(pts, sc))[0]
    assert got == _want(dlogs, ks)
    jout = jmsm.msm(to_numpy_points(pts), FR.to_limbs16(sc),
                    window_bits=8)
    assert o.G1.to_affine(jcv.g1_decode(
        np.asarray(jax.block_until_ready(jout))[None])[0]) == got


def test_msm_1024_matches_oracle():
    pts, dlogs, ks = _instance(1024, 2)
    got = tmsm.msm(pts, tcv.fr_to_scalar_limbs(ks))
    assert tcv.g1_affine(got)[0] == _want(dlogs, ks)


def test_msm_zero_and_duplicate_digits():
    """Zero scalars (empty buckets) and all-equal scalars (one run per
    window holding every point), as tests/test_msm.py:47-61."""
    pts, dlogs, _ = _instance(128, 3)
    k = _ints(1, np.random.default_rng(4))[0]
    ks = [0] * 64 + [k] * 64
    got = tmsm.msm(pts, tcv.fr_to_scalar_limbs(ks))
    assert tcv.g1_affine(got)[0] == _want(dlogs, ks)


def test_msm_point_groups_fold(monkeypatch):
    """Points split into groups whose window sums fold with g1_add (at a
    2^16 row there are 8); here 4 groups of 64 points, the last group
    padded."""
    monkeypatch.setattr(tmsm, "MIN_GROUP_POINTS", 64)
    pts, dlogs, ks = _instance(250, 5)
    assert tmsm._groups(250) == 2
    monkeypatch.setattr(tmsm, "MIN_GROUP_POINTS", 32)
    assert tmsm._groups(250) == 4
    sc = tcv.fr_to_scalar_limbs(ks)
    perm, starts, counts = tmsm.bucket_runs(sc, 4)
    assert perm.shape == (4 * 32, 63) and counts.sum(1).tolist() == \
        [63] * (3 * 32) + [61 + 2] * 32
    assert tcv.g1_affine(tmsm.msm(pts, sc))[0] == _want(dlogs, ks)


def test_msm_auto_naive_path():
    pts, dlogs, ks = _instance(16, 6)
    assert 16 <= tmsm.NAIVE_THRESHOLD
    got = tmsm.msm_auto(pts, tcv.fr_to_scalar_limbs(ks))
    assert tcv.g1_affine(got)[0] == _want(dlogs, ks)
    got = tmsm.msm_naive(pts[:5], tcv.fr_to_scalar_limbs(ks[:5]))
    assert tcv.g1_affine(got)[0] == _want(dlogs[:5], ks[:5])
