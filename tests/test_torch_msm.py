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
    perm, digits = tmsm.bucket_runs(sc, 4)
    assert perm.shape == digits.shape == (4 * 32, 63)
    assert digits.dtype == torch.uint8
    assert bool((digits[:, 1:] >= digits[:, :-1]).all())        # sorted
    # the last group's 2 padded entries: digit 0, index clamped to n − 1
    assert bool(((digits[96:] == 0).sum(1) >= 2).all())
    assert int(perm.max()) == 249
    assert tcv.g1_affine(tmsm.msm(pts, sc))[0] == _want(dlogs, ks)


def test_msm_auto_naive_path():
    pts, dlogs, ks = _instance(16, 6)
    assert 16 <= tmsm.NAIVE_THRESHOLD
    got = tmsm.msm_auto(pts, tcv.fr_to_scalar_limbs(ks))
    assert tcv.g1_affine(got)[0] == _want(dlogs, ks)
    got = tmsm.msm_naive(pts[:5], tcv.fr_to_scalar_limbs(ks[:5]))
    assert tcv.g1_affine(got)[0] == _want(dlogs[:5], ks[:5])


@pytest.mark.parametrize("own_points", [False, True],
                         ids=["shared points", "points a row"])
def test_msm_auto_many_sums_in_one_tree(own_points):
    """msm_auto_many's naive path sums its K rows' products in one tree of
    adds (log2 N g1_add calls for all K): limb for limb K g1_sum calls over
    the ladder's products, and the oracle; N = 13 pads each row with
    infinity to 16; K = 3 over shared points or over points of their own a
    row."""
    pts, dlogs, _ = _instance(13, 8)
    rng = np.random.default_rng(9)
    ks = [[0, 1, o.R - 1] + _ints(10, rng)] + [_ints(13, rng)
                                               for _ in range(2)]
    sc = torch.stack([tcv.fr_to_scalar_limbs(k) for k in ks])
    if own_points:
        rows = torch.stack([pts, pts.roll(1, 0), pts.roll(2, 0)])
        logs = [dlogs, dlogs[-1:] + dlogs[:-1], dlogs[-2:] + dlogs[:-2]]
    else:
        rows, logs = pts, [dlogs] * 3
    adds = []
    real_add = tmsm.g1_add
    try:
        tmsm.g1_add = lambda a, b: adds.append(a.shape) or real_add(a, b)
        got = tmsm.msm_auto_many(rows, sc)
    finally:
        tmsm.g1_add = real_add
    assert adds == [(3, 8, 3, 12), (3, 4, 3, 12), (3, 2, 3, 12),
                    (3, 1, 3, 12)]
    prods = tcv.g1_scalar_mul(
        rows.reshape(-1, 3, 12) if own_points else rows.repeat(3, 1, 1),
        sc.reshape(-1, 8)).view(3, 13, 3, 12)
    assert torch.equal(got, torch.stack([tcv.g1_sum(p) for p in prods]))
    for c in range(3):
        assert tcv.g1_affine(got[c])[0] == _want(logs[c], ks[c]), c


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
    perm, digits = tmsm.bucket_runs(sc, 2)
    assert perm.shape == digits.shape == (2 * 2 * 32, 19)
    for k in range(2):                  # rows are (group, MSM, window)
        single = tmsm.bucket_runs(sc[k], 2)
        rows = [g * 64 + k * 32 + w for g in range(2) for w in range(32)]
        for both, one in zip((perm, digits), single):
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


# -- the bucket kernel's tiles: plain version against a per-bucket walk --------

def _per_bucket_walk(points, perm, digits):
    """Each bucket ≠ 0 summed alone, from infinity along its sorted run: the
    bucket kernel's design before tiles, kept as the reference."""
    rows, n = perm.shape
    d = digits.long()
    counts = torch.zeros((rows, tmsm.NUM_BUCKETS), dtype=torch.long)
    counts.scatter_add_(1, d, torch.ones_like(d))
    starts = (torch.cumsum(counts, 1) - counts).reshape(-1)
    counts[:, 0] = 0                                    # bucket 0: unused
    counts = counts.reshape(-1)
    base = torch.arange(rows).repeat_interleave(tmsm.NUM_BUCKETS) * n
    acc = tcv.g1_infinity((counts.numel(),))
    for k in range(int(counts.max()) if counts.numel() else 0):
        on = torch.nonzero(counts > k).squeeze(-1)
        idx = perm.reshape(-1).long()[base[on] + starts[on] + k]
        acc[on] = tcv.g1_add_plain(acc[on], points[idx])
    return acc.view(rows, tmsm.NUM_BUCKETS, 3, 12)


def _digit_rows(case, n, rng):
    """Three sorted digit rows of n entries for one case."""
    if case == "random":
        rows = [rng.integers(0, 256, n) for _ in range(3)]
    elif case == "all zero":
        rows = [np.zeros(n, int)] * 3
    elif case == "all equal":
        rows = [np.full(n, v) for v in (7, 200, 77)]
    elif case == "only bucket 1":
        rows = [np.full(n, 1)] * 3
    elif case == "only bucket 255":
        rows = [np.full(n, 255)] * 3
    elif case == "runs crossing every tile edge":
        # runs of 1, 5, 3, 9, 2, ... entries: at tiles of 2 to 8 they start
        # and end at every offset, and some span several tiles
        lengths = np.resize([1, 5, 3, 9, 2, 7, 4, 11, 6], n)
        rows = [np.repeat(np.arange(1, n + 1) % 256, lengths)[:n]
                for _ in range(3)]
    else:
        assert case == "one bucket holds the whole row"
        rows = [np.concatenate([np.zeros(z, int), np.full(n - z, 9)])
                for z in (0, 3, n - 1)]
    return torch.tensor(np.sort(np.stack(rows), axis=1), dtype=torch.uint8)


_TILE_CASES = ["random", "all zero", "all equal", "only bucket 1",
               "only bucket 255", "runs crossing every tile edge",
               "one bucket holds the whole row"]


@pytest.fixture(scope="module")
def toy_points():
    pts, dlogs, _ = _instance(40, 21)
    return tcv.g1_double_plain(pts), [2 * a % o.R for a in dlogs]  # Z ≠ 1


def _oracle_buckets(perm, digits, dlogs):
    want = []
    for p_row, d_row in zip(perm.tolist(), digits.tolist()):
        sums = {}
        for i, d in zip(p_row, d_row):
            if d:
                sums[d] = (sums.get(d, 0) + dlogs[i]) % o.R
        want.append([o.G1.to_affine(o.G1.mul(G, sums[b])) if b in sums
                     else None for b in range(tmsm.NUM_BUCKETS)])
    return want


@pytest.mark.parametrize("case", _TILE_CASES)
def test_buckets_plain_tiles_match_per_bucket_walk(toy_points, case):
    """The tiled bucket sums at tiles of 2, 3 and 8 (toy rows of 29
    entries) and at the kernel's own tile (29 < 256 threads: one entry a
    thread), against the per-bucket walk and the oracle, as points."""
    pts, dlogs = toy_points
    rng = np.random.default_rng(22)
    n = 29
    digits = _digit_rows(case, n, rng)
    perm = torch.tensor(np.stack([rng.permutation(40)[:n] for _ in range(3)]),
                        dtype=torch.int32)
    want = _oracle_buckets(perm, digits, dlogs)
    ref = _per_bucket_walk(pts, perm, digits)
    assert [tcv.g1_affine(r) for r in ref] == want
    assert tmsm.bucket_tile(n) == 1
    for tile in (2, 3, 8, None):
        got = tmsm.msm_buckets_plain(pts, perm, digits, tile)
        assert got.shape == (3, 256, 3, 12)
        assert [tcv.g1_affine(r) for r in got] == want, tile
        assert torch.equal(got[:, 0], tcv.g1_infinity((3,)))


def test_buckets_plain_padded_last_group(toy_points):
    """Rows from bucket_runs with a padded last group (37 points in 2
    groups of 19): the padding (digit 0, index clamped) is never added."""
    pts, dlogs = toy_points
    rng = np.random.default_rng(23)
    ks = _ints(37, rng)
    ks[30:] = [0x0101] * 7                  # a run of bucket 1 in the last group
    perm, digits = tmsm.bucket_runs(tcv.fr_to_scalar_limbs(ks), 2)
    assert perm.shape == (64, 19)
    rows = [0, 1, 31, 32, 33, 63]
    perm, digits = perm[rows].contiguous(), digits[rows].contiguous()
    # group 1 holds points 19..36 and one padded entry: index 36 twice
    assert ((perm[3:] == 36).sum(1) == 2).all()
    assert int((digits[3:] == 0).sum(1).min()) >= 1
    want = _oracle_buckets(perm, digits, dlogs)
    for tile in (4, None):
        got = tmsm.msm_buckets_plain(pts, perm, digits, tile)
        assert [tcv.g1_affine(r) for r in got] == want


def test_bucket_depth_bounded_whatever_the_digits():
    """The longest chain of dependent adds depends on the row length only:
    at the path's 8192 entries a row, tiles of 32, 31 + 8 + 1 = 40 (a run
    of 8192 equal digits was 8192 in one thread)."""
    assert tmsm.bucket_tile(8192) == 32
    assert tmsm.bucket_depth(8192) == 40
    assert tmsm.bucket_depth(29, 8) == 7 + 2 + 1
    assert tmsm.bucket_depth(300) == 1 + 8 + 1


# -- msm_fixed: MSMs over fixed bases through their window table -------------

@pytest.fixture(scope="module")
def fixed_16():
    """16 bases [a_i]G in projective form with Z ≠ 1 (one of them infinity)
    and their window table."""
    pts, dlogs, _ = _instance(16, 31)
    pts = tcv.g1_double(pts)
    pts[5] = tcv.g1_infinity(())
    dlogs = [2 * d % o.R for d in dlogs]
    dlogs[5] = 0
    return pts, dlogs, tmsm.fixed_table(pts)


def test_fixed_table_plain_holds_the_windows(fixed_16):
    """fixed_table: table[i, w, j] = [(j + 1)·16^w]P_i, against the oracle:
    every multiple of a window, the first and last windows, the base at
    infinity."""
    pts, dlogs, table = fixed_16
    assert table.shape == (16, tmsm.FIXED_WINDOWS, tmsm.FIXED_MULTIPLES,
                           3, 12) == (16, 64, 8, 3, 12)
    cells = [(1, 1, j) for j in range(8)] + [
        (0, 0, 0), (2, 63, 7), (5, 7, 3), (15, 16, 4), (9, 40, 6)]
    for i, w, j in cells:
        assert tcv.g1_affine(table[i, w, j]) == [o.G1.to_affine(o.G1.mul(
            G, dlogs[i] * (j + 1) * pow(16, w, o.R) % o.R))], (i, w, j)


@pytest.mark.parametrize("k", [0, 1, 8, 9, 0x88, 0x89, 2 ** 255 - 1,
                               o.R - 1, o.R - 2, None])
def test_fixed_digits_recode_every_scalar(k):
    """The signed digits: 64 of them in [-7, 8] with Σ d_w·16^w = k (one
    such recoding exists for each k < 2^255), and csrc/g1.cu's rule for
    the carry into window w (k mod 16^w > 0x88…8, w nibbles) gives the
    same digits as the plain version's running carry."""
    if k is None:
        k = _ints(1, np.random.default_rng(41))[0]
    limbs = np.frombuffer(k.to_bytes(32, "little"), "<i4").copy()
    d = tmsm.fixed_digits_plain(torch.from_numpy(limbs)).tolist()
    assert len(d) == 64 and min(d) >= -7 and max(d) <= 8
    assert sum(x * 16 ** w for w, x in enumerate(d)) == k

    def kernel_digit(w):
        carry = k % 16 ** w > int("8" * w or "0", 16)
        v = (k >> 4 * w & 15) + carry
        return v - 16 if v > 8 else v
    assert [kernel_digit(w) for w in range(64)] == d


@pytest.mark.parametrize("m", [4, 16])
def test_msm_fixed_plain_matches_naive_and_oracle(fixed_16, m):
    """msm_fixed's plain version (the kernel's signed-digit terms and tree
    of launches) for K = 3 MSMs at once against the oracle, and the first
    against msm_naive (the ladder and a tree): scalars 0, 1, r − 1, r − 2
    and random, a base at infinity, at M = 4 (256 terms: 8 blocks, then
    one) and 16 (1024 terms: 32 blocks, then one)."""
    pts, dlogs, table = fixed_16
    rng = np.random.default_rng(37 + m)
    ks = [[0, 1, o.R - 1, o.R - 2][:m] + _ints(m - 4, rng)
          for _ in range(3)]
    ks[2] = [o.R - 1] * m
    sc = torch.stack([tcv.fr_to_scalar_limbs(k) for k in ks])
    got = tmsm.msm_fixed_plain(table[:m], sc)
    for c in range(3):
        assert tcv.g1_affine(got[c]) == [_want(dlogs[:m], ks[c])], c
    assert tcv.g1_affine(tmsm.msm_naive(pts[:m], sc[0])) == \
        tcv.g1_affine(got[0])
    assert torch.equal(tmsm.msm_fixed(table[:m], sc), got)


@pytest.mark.parametrize("m, passes", [
    (1, [64, 2, 1]),            # two blocks, then one block of two
    (2, [128, 4, 1]),           # a block of four
    (16, [1024, 32, 1]),        # full blocks at both launches
    (17, [1088, 34, 2, 1]),     # a ragged block of two at launch 2
    (33, [2112, 66, 3, 1])])    # ragged: 2 at launch 2, then 3 padded to 4
def test_msm_fixed_plain_crosses_every_block_boundary(fixed_16, m, passes):
    """The tree of launches at the kernel's fan-in of 32: one block, two
    blocks, ragged last blocks (padded with infinity to their power of
    two) at one and two launches, against the oracle. The table of the 16
    keys, repeated, is the table of more (an entry depends on its key
    alone)."""
    _, dlogs, table = fixed_16
    rng = np.random.default_rng(43 + m)
    ks = [[o.R - 1] + _ints(m - 1, rng), _ints(m, rng)]
    sc = torch.stack([tcv.fr_to_scalar_limbs(k) for k in ks])
    assert tmsm.kernels.fixed_passes(m) == passes
    reps = -(-m // 16)
    got = tmsm.msm_fixed_plain(table.repeat(reps, 1, 1, 1, 1)[:m], sc)
    for c in range(2):
        assert tcv.g1_affine(got[c]) == [_want((dlogs * reps)[:m], ks[c])], c


@pytest.mark.parametrize("m, passes", [
    (1, [64, 2, 1]), (16, [1024, 32, 1]), (256, [16384, 512, 16, 1]),
    (1024, [65536, 2048, 64, 2, 1]), (4096, [262144, 8192, 256, 8, 1])])
def test_fixed_passes_count_each_launchs_inputs(m, passes):
    """``kernels.fixed_passes``: the inputs of each launch of the kernel's
    tree (the 64·m terms, then ceil(n / 32) block sums a launch), whose
    second and third entries size the wrapper's scratch."""
    assert tmsm.kernels.fixed_passes(m) == passes
