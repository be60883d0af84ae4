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
from zkp_subnet_tpu_torch.models import kzg
from zkp_subnet_tpu_torch.models.srs import to_numpy_points
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import msm_rounds
from zkp_subnet_tpu_torch.ops.field import FR
from zkp_subnet_tpu_torch.runtime.worker import prove_row


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


# -- the segmented reduction, the batched Horner and the batched MSM -----------

def _running_sum(buckets):
    """Σ_d d·B_d per row by the running sum over the whole row: the
    reference the segmented reduction is held to."""
    running = total = tcv.g1_infinity((buckets.shape[0],))
    for d in range(buckets.shape[1] - 1, 0, -1):
        running = tcv.g1_add_plain(running, buckets[:, d])
        total = tcv.g1_add_plain(total, running)
    return total


def _horner(window_sums, window_bits):
    """One chain's Σ_w 2^(wb·w)·S_w, most significant window first."""
    acc = tcv.g1_infinity(())
    for w in range(window_sums.shape[0] - 1, -1, -1):
        for _ in range(window_bits):
            acc = tcv.g1_double_plain(acc)
        acc = tcv.g1_add_plain(acc, window_sums[w])
    return acc


def _bucket_row(case, nb, rng):
    """(dlogs of one row's nb buckets, None for infinity)."""
    a = _ints(1, rng, lo=1)[0]
    if case == "random":
        return [None if d % 7 == 3 else (a + 977 * d) % o.R
                for d in range(nb)]
    if case == "all infinity":
        return [None] * nb
    if case == "only bucket 1":
        return [None, a] + [None] * (nb - 2)
    if case == "only the top bucket":
        return [None] * (nb - 1) + [a]
    if case == "equal points":
        return [a] * nb
    assert case == "a bucket and its negative"
    return [None if d not in (5, nb - 3) else (a if d == 5 else o.R - a)
            for d in range(nb)]


def _bucket_tensor(rows_dlogs):
    pts = [o.G1.infinity() if a is None else o.G1.mul(G, a)
           for row in rows_dlogs for a in row]
    return tcv.g1_encode(pts).reshape(len(rows_dlogs), len(rows_dlogs[0]),
                                      3, 12)


def _weighted(dlogs):
    return o.G1.to_affine(o.G1.mul(G, sum(d * (a or 0) for d, a in
                                          enumerate(dlogs)) % o.R))


_REDUCE_CASES = ["random", "all infinity", "only bucket 1",
                 "only the top bucket", "equal points",
                 "a bucket and its negative"]


@pytest.fixture(scope="module")
def reduced_256():
    """One row of 256 buckets per case (bucket 0 filled: it must not
    count), reduced once by the segmented reduction and once by the
    running sum."""
    rng = np.random.default_rng(11)
    dlogs = [_bucket_row(c, tmsm.NUM_BUCKETS, rng) for c in _REDUCE_CASES]
    buckets = _bucket_tensor(dlogs)
    buckets[:, 0] = tcv.g1_encode([o.G1.mul(G, 12345)])[0]
    return (dlogs, tcv.g1_affine(tmsm.msm_reduce_plain(buckets)),
            tcv.g1_affine(_running_sum(buckets)))


@pytest.mark.parametrize("case", _REDUCE_CASES)
def test_reduce_plain_256_buckets(reduced_256, case):
    """The segmented reduction at the MSM's 256 buckets against the
    running sum and the oracle."""
    dlogs, got, running = reduced_256
    i = _REDUCE_CASES.index(case)
    assert got[i] == running[i] == _weighted(dlogs[i])
    assert tmsm.reduce_depth() == 27 <= 40


@pytest.mark.parametrize("segment", [2, 4, 8])
def test_reduce_plain_segments(segment):
    """The decomposition at three segment lengths, on rows of 32 buckets
    with general Z, against the running sum."""
    rng = np.random.default_rng(12)
    rows = [_bucket_row(c, 32, rng) for c in ("random", "equal points",
                                              "a bucket and its negative")]
    buckets = tcv.g1_double_plain(_bucket_tensor(rows))    # Z ≠ 1
    got = tcv.g1_affine(tmsm.msm_reduce_plain(buckets, segment))
    assert got == tcv.g1_affine(_running_sum(buckets))
    assert got == [_weighted([2 * a if a else a for a in r]) for r in rows]
    assert tmsm.reduce_depth(32, segment) == \
        {2: 1 + 4 + 4 + 1 + 1, 4: 5 + 3 + 3 + 2 + 1, 8: 13 + 2 + 2 + 3 + 1}[
            segment]
    with pytest.raises(ValueError):
        tmsm.msm_reduce_plain(buckets, 3)
    with pytest.raises(ValueError):
        tmsm.msm_reduce_plain(buckets, 32)


@pytest.mark.parametrize("chains", [1, 3])
def test_combine_plain_matches_per_chain_horner(chains):
    rng = np.random.default_rng(13)
    windows, wb = 4, 8
    dlogs = [_ints(windows, rng) for _ in range(chains)]
    dlogs[-1][1] = None                                    # an empty window
    sums = tcv.g1_double_plain(_bucket_tensor(dlogs))
    got = tmsm.msm_combine_plain(sums, wb)
    assert got.shape == (chains, 3, 12)
    for k in range(chains):
        assert torch.equal(got[k], _horner(sums[k], wb))
        assert torch.equal(got[k], tmsm.msm_combine_plain(sums[k], wb))
        want = sum((2 * (a or 0)) << (wb * w) for w, a in enumerate(dlogs[k]))
        assert tcv.g1_affine(got[k]) == \
            [o.G1.to_affine(o.G1.mul(G, want % o.R))]


def test_combine_tables_compute_the_point_formulas():
    """The rounds the combine kernel's lanes run (msm_rounds.DOUBLE_ROUNDS,
    ADD_ROUNDS), executed on the CPU, give the limbs of the complete double
    and add, edge cases included."""
    pts, _, _ = _instance(6, 14)
    p = tcv.g1_double_plain(pts)
    q = torch.roll(p, 1, 0)
    q[0] = p[0]                                            # P + P
    q[1] = tcv.g1_neg(p[1:2])[0]                           # P + (−P)
    p[2] = tcv.g1_infinity(())                             # ∞ + Q
    q[3] = tcv.g1_infinity(())                             # P + ∞
    p[4] = q[4] = tcv.g1_infinity(())                      # ∞ + ∞
    double, add = (msm_rounds.assemble(r) for r in (msm_rounds.DOUBLE_ROUNDS,
                                                    msm_rounds.ADD_ROUNDS))
    prog = msm_rounds.program("cpu")
    assert prog.table.shape == (len(double) + len(add), msm_rounds.LANES)
    assert prog.table.tolist() == double + add
    assert prog.double_rounds == len(double)

    def run(table, *points):
        slots = {3 * i + c: pt[:, c] for i, pt in enumerate(points)
                 for c in range(3)}
        tmsm.run_rounds_plain(table, slots)
        assert max(slots) < prog.slots
        return torch.stack([slots[0], slots[1], slots[2]], dim=1)

    assert torch.equal(run(double, p), tcv.g1_double_plain(p))
    assert torch.equal(run(add, p, q), tcv.g1_add_plain(p, q))
    with pytest.raises(ValueError):     # a round may not read what it writes
        msm_rounds.assemble(
            ((("t", "add", "X1", "Y1"), ("u", "add", "t", "X1")),))


def test_msm_many_matches_msm_and_oracle(monkeypatch):
    """Two MSMs side by side (2 point groups, the last one padded) equal
    two single MSMs limb for limb, and the oracle."""
    monkeypatch.setattr(tmsm, "MIN_GROUP_POINTS", 16)
    pts, dlogs, ks = _instance(37, 15)
    assert tmsm._groups(37) == 2
    all_ks = [ks, [0] * 20 + [ks[0]] * 17]
    sc = torch.stack([tcv.fr_to_scalar_limbs(k) for k in all_ks])
    perm, starts, counts = tmsm.bucket_runs(sc, 2)
    assert perm.shape == (2 * 2 * 32, 19) and starts.shape == (128, 256)
    for k in range(2):                  # rows are (group, MSM, window)
        single = tmsm.bucket_runs(sc[k], 2)
        rows = [g * 64 + k * 32 + w for g in range(2) for w in range(32)]
        for both, one in zip((perm, starts, counts), single):
            assert torch.equal(both[rows], one)
    got = tmsm.msm_many(pts, sc)
    assert got.shape == (2, 3, 12)
    for k, scalars in enumerate(all_ks):
        assert torch.equal(got[k], tmsm.msm(pts, sc[k]))
        assert tcv.g1_affine(got[k]) == [_want(dlogs, scalars)]
    assert tmsm.msm_many(pts[:0], sc[:, :0]).shape == (2, 3, 12)


def test_prove_row_matches_commit_and_open(monkeypatch):
    """The worker's one batched Pippenger MSM gives the limbs of kzg.commit
    and kzg.open_ run one after the other (tests/test_torch_worker.py holds
    the naive path to the JAX package's outputs)."""
    monkeypatch.setattr(tmsm, "NAIVE_THRESHOLD", 0)
    bases, _, ks = _instance(8, 17)
    row = FR.encode(ks)
    x = FR.encode([0x1234567])[0]
    com, y, prf = prove_row(bases, row, x)
    y_ref, prf_ref = kzg.open_(bases, row, x)
    assert torch.equal(com, kzg.commit(bases, row))
    assert torch.equal(y, y_ref) and torch.equal(prf, prf_ref)
