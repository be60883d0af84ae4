"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); without one every test here skips.
The module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none (integer arithmetic; points compared as affine points,
``msm_buckets``, ``msm_reduce``, ``msm_combine``, ``g1_scalar_mul`` (both
of its forms), ``g1_fixed_table`` and ``g1_msm_fixed`` limb for limb).
"""

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import ntt as tntt
from zkp_subnet_tpu_torch.ops import poly as tpoly
from zkp_subnet_tpu_torch.ops.field import (FQ, FR, fr_inv_plain,
                                            fr_power_tables_plain,
                                            fr_powers_plain)
from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.runtime.server import rpc
from zkp_subnet_tpu_torch.runtime.worker import Prove, Worker
from zkp_subnet_tpu_torch.utils import encoding as enc
from zkp_subnet_tpu_torch.utils import oracle as o

pytestmark = pytest.mark.cuda

G = o.G1.from_affine(o.G1_GEN)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    kernels.build()
    return torch.device("cuda", 0)


def _instance(n, seed):
    rng = np.random.default_rng(seed)
    a, s = (int(v) for v in rng.integers(1, 1 << 62, 2))
    p, step, pts = o.G1.mul(G, a), o.G1.mul(G, s), []
    for _ in range(n):
        pts.append(p)
        p = o.G1.add(p, step)
    ks = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(n)]
    return tcv.g1_encode(pts), [(a + i * s) % o.R for i in range(n)], ks


def test_fr_kernels_match_plain(dev):
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(999)]
    vals[:3] = [0, 1, o.R - 1]
    a = FR.encode(vals)
    b = FR.encode(vals[::-1])
    for kern, plain in ((kernels.fr_mul, FR.mont_mul_plain),
                        (kernels.fr_add, FR.add_plain)):
        assert torch.equal(kern(a.to(dev), b.to(dev)).cpu(), plain(a, b))
        assert torch.equal(kern(a.to(dev), b[:1].to(dev)).cpu(),
                           plain(a, b[:1]))


def _field_values(p, seed, n=999):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def _binary_cases(F, kern, plain, dev, seed):
    """Full operands, equal operands, and a broadcast operand on each side."""
    vals = _field_values(F.p, seed)
    a, b = F.encode(vals), F.encode(vals[::-1])
    b[5] = a[5]
    ad, bd = a.to(dev), b.to(dev)
    assert torch.equal(kern(ad, bd).cpu(), plain(a, b))
    assert torch.equal(kern(ad, ad).cpu(), plain(a, a))
    assert torch.equal(kern(ad, bd[:1]).cpu(), plain(a, b[:1]))
    assert torch.equal(kern(bd[2:3], ad).cpu(), plain(b[2:3], a))


def test_fr_sub_kernel_matches_plain(dev):
    _binary_cases(FR, kernels.fr_sub, FR.sub_plain, dev, 11)
    a = FR.encode(_field_values(FR.p, 12, 50)).to(dev)
    assert FR.decode(FR.neg(a)) == [-x % o.R for x in FR.decode(a)]


def test_fq_mul_kernel_matches_plain(dev):
    _binary_cases(FQ, kernels.fq_mul, FQ.mont_mul_plain, dev, 13)


def test_fq_add_kernel_matches_plain(dev):
    _binary_cases(FQ, kernels.fq_add, FQ.add_plain, dev, 14)


def test_fq_sub_kernel_matches_plain(dev):
    _binary_cases(FQ, kernels.fq_sub, FQ.sub_plain, dev, 15)


def test_field_kernels_refuse_a_misaligned_tensor(dev):
    """The kernels move an element as 16-byte words: a view that starts 4
    bytes into its storage raises rather than being read misaligned."""
    for limbs, kern in ((8, kernels.fr_add), (12, kernels.fq_add)):
        good = torch.zeros((4, limbs), dtype=torch.int32, device=dev)
        flat = torch.zeros(4 * limbs + 1, dtype=torch.int32, device=dev)
        skewed = flat[1:].view(4, limbs)
        assert kern(good, good[1:2]).shape == (4, limbs)
        with pytest.raises(ValueError, match="16-byte aligned"):
            kern(skewed, good)
        with pytest.raises(ValueError, match="16-byte aligned"):
            kern(good, skewed)


def test_fr_butterfly_kernel_matches_plain(dev):
    """Every stage of a size-64 transform over 3 rows, in place."""
    log_n, n = 6, 64
    v = FR.encode(_field_values(FR.p, 16, 3 * n)).reshape(3, n, FR.L)
    tw = tntt.twiddles(log_n, False)
    vd, twd = v.to(dev), tw.to(dev)
    for stage in range(1, log_n + 1):
        v = tntt.fr_butterfly_plain(v, tw, stage)
        out = kernels.fr_butterfly(vd, twd, stage)
        assert out.data_ptr() == vd.data_ptr()
        assert torch.equal(vd.cpu(), v), stage


def test_ntt_round_trip_on_card(dev):
    vals = _field_values(FR.p, 17, 4 * 256)
    x = FR.encode(vals).reshape(4, 256, FR.L).to(dev)
    fwd = tntt.ntt_batch(x)
    assert FR.decode(fwd[1]) == o.ntt(vals[256:512])
    assert torch.equal(tntt.ntt_batch(fwd, inverse=True), x)
    assert torch.equal(tntt.intt(tntt.ntt(x[0])), x[0])


def test_fixed_base_mul_and_inverse_on_card(dev):
    ks = [0, 1, o.R - 1] + _field_values(FR.p, 18, 61)
    got = tcv.g1_fixed_base_mul(tcv.g1_fixed_base_tables(device=dev),
                                tcv.fr_to_scalar_limbs(ks, dev))
    assert tcv.g1_affine(got) == [o.G1.to_affine(o.G1.mul(G, k)) for k in ks]
    a = FR.encode(ks, dev)
    assert FR.decode(FR.inv(a)) == [pow(k, o.R - 2, o.R) for k in ks]


def test_g1_kernels_match_plain(dev):
    p, _, _ = _instance(300, 2)
    p = tcv.g1_double_plain(p)                 # Z ≠ 1
    q = torch.roll(p, 1, 0)
    q[0] = p[0]                                # P + P
    q[1] = tcv.g1_neg(p[1:2])[0]               # P + (−P)
    p[2] = tcv.g1_infinity(())                 # ∞ + Q
    q[3] = tcv.g1_infinity(())                 # P + ∞
    p[4] = q[4] = tcv.g1_infinity(())          # ∞ + ∞
    p[5] = p[6] = q[6]                         # equal projective
    got = kernels.g1_add(p.to(dev), q.to(dev)).cpu()
    assert torch.equal(got, tcv.g1_add_plain(p, q))
    got = kernels.g1_double(p.to(dev)).cpu()
    assert torch.equal(got, tcv.g1_double_plain(p))


@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 127, 128, 129,
                               (1 << 16) + 3])
def test_g1_double_kernel_at_every_boundary(dev, n):
    """K1 g1_double limb for limb against its plain version (on the card)
    at every boundary of a warp (32 points) and a block (128 points) of its
    kernel and past one wave of the card, on points with Z != 1 and the
    point at infinity among them."""
    pts, _, _ = _instance(64, 31)
    pts = tcv.g1_double_plain(pts)             # Z ≠ 1
    pts[2] = pts[40] = tcv.g1_infinity(())
    p = pts.to(dev).repeat(-(-n // 64), 1, 1)[:n].contiguous()
    assert torch.equal(kernels.g1_double(p), tcv.g1_double_plain(p))


def test_msm_on_card_matches_oracle(dev, monkeypatch):
    monkeypatch.setattr(tmsm, "MIN_GROUP_POINTS", 128)
    pts, dlogs, ks = _instance(1000, 3)
    sc = tcv.fr_to_scalar_limbs(ks)
    got = tmsm.msm(pts.to(dev), sc.to(dev))
    want = sum(a * k for a, k in zip(dlogs, ks)) % o.R
    assert tcv.g1_affine(got)[0] == o.G1.to_affine(o.G1.mul(G, want))


def test_worker_on_card_matches_cpu(dev):
    tau = 0x5EED0F7A015F1BED
    n = 16
    bases = tcv.g1_encode([o.G1.mul(G, pow(tau, j, o.R)) for j in range(n)])
    g2 = o.G2.from_affine(o.G2_GEN)

    def worker(device):
        b = bases.to(device)
        return Worker(Srs(scale=4, machines_scale=0, g1_x=b,
                          worker_bases=b[None],
                          lagrange_y=tcv.g1_encode([G], device),
                          g2_gen=g2, g2_tau_x=o.G2.mul(g2, tau),
                          g2_tau_y=g2))

    rng = np.random.default_rng(4)
    row = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(n)]
    req = Prove(index=0, poly=enc.poly_to_b64(row), alpha=enc.fr_to_b64(77))
    on_card = worker(dev).forward(req)
    on_cpu = worker(torch.device("cpu")).forward(req)
    assert on_card.commitment is not None and on_card.proof is not None
    assert (on_card.commitment, on_card.eval_, on_card.proof) == \
        (on_cpu.commitment, on_cpu.eval_, on_cpu.proof)


@pytest.fixture(scope="module")
def path_buckets(dev):
    """Bucket sums at the main path's shape: two MSMs of 2^16 scalars over
    the same bases, 8 point groups → (512, 256, 3, 12)."""
    n = 1 << 16
    pts, _, _ = _instance(256, 5)
    pts = tcv.g1_double_plain(pts).to(dev).repeat(n // 256, 1, 1)
    rng = np.random.default_rng(6)
    limbs = rng.integers(0, 1 << 16, (2, n, 16), dtype=np.uint32)
    sc = FR.from_limbs16(limbs, dev)
    runs = tmsm.bucket_runs(sc, tmsm._groups(n))
    return kernels.msm_buckets(pts, *runs)


@pytest.mark.parametrize("rows", [256, 512])
def test_msm_reduce_kernel_equals_plain_limb_for_limb(dev, path_buckets,
                                                      rows):
    assert path_buckets.shape == (512, 256, 3, 12)
    bk = path_buckets[:rows]
    got = kernels.msm_reduce(bk)
    assert got.shape == (rows, 3, 12)
    assert torch.equal(got, tmsm.msm_reduce_plain(bk))
    assert torch.equal(got.cpu(), tmsm.msm_reduce_plain(bk.cpu()))
    assert torch.equal(got, tmsm.msm_reduce(bk))


@pytest.mark.parametrize("chains", [1, 2])
def test_msm_combine_kernel_equals_plain_limb_for_limb(dev, path_buckets,
                                                       chains):
    sums = tmsm.msm_reduce(path_buckets)[:64].view(2, 32, 3, 12)
    wins = sums[0] if chains == 1 else sums
    got = tmsm.msm_combine(wins)
    assert got.shape == wins.shape[:-3] + (3, 12)
    assert torch.equal(got, tmsm.msm_combine_plain(wins))
    assert torch.equal(got.cpu(), tmsm.msm_combine_plain(wins.cpu()))


def test_msm_kernels_refuse_what_they_do_not_take(dev):
    bk = tcv.g1_infinity((4, 256), dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.msm_reduce(bk.cpu())
    with pytest.raises(ValueError):
        kernels.msm_reduce(bk[:, :, :, :8])                # not (..., 3, 12)
    with pytest.raises(ValueError):
        kernels.msm_reduce(bk[0])                          # no rows
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.msm_reduce(bk[:, :24].contiguous())        # 3 lanes a row
    wins = tcv.g1_infinity((2, 32), dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.msm_combine(wins.cpu(), 8)
    with pytest.raises(ValueError):
        kernels.msm_combine(wins[0, 0], 8)                 # no windows
    with pytest.raises(ValueError):
        kernels.msm_combine(wins[..., :8], 8)              # not (..., 3, 12)
    assert tcv.g1_affine(tmsm.msm_combine(wins)) == [None, None]
    assert tcv.g1_affine(tmsm.msm_reduce(bk)) == [None] * 4


def test_msm_many_on_card_matches_msm_and_oracle(dev, monkeypatch):
    monkeypatch.setattr(tmsm, "MIN_GROUP_POINTS", 128)
    pts, dlogs, ks = _instance(1000, 7)
    all_ks = [ks, ks[::-1]]
    sc = torch.stack([tcv.fr_to_scalar_limbs(k) for k in all_ks]).to(dev)
    before = dict(kernels.LAUNCHES)
    got = tmsm.msm_many(pts.to(dev), sc)
    used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert (used["msm_buckets"], used["msm_reduce"], used["msm_combine"]) \
        == (1, 1, 1)
    for j, scalars in enumerate(all_ks):
        assert torch.equal(got[j], tmsm.msm(pts.to(dev), sc[j]))
        want = sum(a * k for a, k in zip(dlogs, scalars)) % o.R
        assert tcv.g1_affine(got[j]) == [o.G1.to_affine(o.G1.mul(G, want))]


@pytest.fixture(scope="module")
def four_sets(dev):
    """4 point sets of 4096 points (2 point groups each) and 2 MSMs a set:
    points (4, 4096, 3, 12), scalars (4, 2, 4096, 8), the dlogs and the
    scalars as integers."""
    n, sets = 4096, 4
    pts, dlogs, ks = _instance(sets * n, 9)
    all_ks = [[ks[j * n:(j + 1) * n], ks[j * n:(j + 1) * n][::-1]]
              for j in range(sets)]
    sc = torch.stack([torch.stack([tcv.fr_to_scalar_limbs(k) for k in pair])
                      for pair in all_ks]).to(dev)
    return (pts.view(sets, n, 3, 12).to(dev), sc,
            [dlogs[j * n:(j + 1) * n] for j in range(sets)], all_ks)


@pytest.mark.parametrize("passes", [1, 2])
def test_msm_auto_groups_on_card_passes_match_msm_many(dev, monkeypatch,
                                                      four_sets, passes):
    """The Pippenger passes over 4 sets × 2 MSMs × 4096 points, in one pass
    at the byte budget or in two of 2 sets: limb for limb a per-set
    msm_many, and the oracle; one msm_buckets, msm_reduce and msm_combine
    a pass, and log2(G) = 1 g1_add a pass."""
    pts, sc, dlogs, all_ks = four_sets
    n, groups = pts.shape[1], tmsm._groups(pts.shape[1])
    assert groups == 2
    if passes == 2:
        monkeypatch.setattr(tmsm, "PASS_BYTES", 2 * groups * (n // groups)
                            * 2 * tmsm.NUM_WINDOWS * tmsm.SORT_ENTRY_BYTES)
    assert -(-pts.shape[0] // tmsm.sets_per_pass(n, 2, groups)) == passes
    before = dict(kernels.LAUNCHES)
    got = tmsm.msm_auto_groups(pts, sc)
    used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    assert (used["msm_buckets"], used["msm_reduce"], used["msm_combine"],
            used["g1_add"]) == (passes,) * 4
    assert got.shape == (4, 2, 3, 12)
    for j in range(4):
        assert torch.equal(got[j], tmsm.msm_many(pts[j], sc[j]))
        for k, scalars in enumerate(all_ks[j]):
            want = sum(a * s for a, s in zip(dlogs[j], scalars)) % o.R
            assert tcv.g1_affine(got[j, k]) == [
                o.G1.to_affine(o.G1.mul(G, want))]


def _sorted_rows(case, n, rows, rng):
    """(perm int32, digits uint8) of `rows` digit-sorted rows of n entries
    over 2^16 points, for one case."""
    if case == "uniform":
        d = rng.integers(0, 256, (rows, n))
    elif case == "all-ones":
        d = np.ones((rows, n), int)
    elif case == "runs that cross tile edges":
        lengths = np.resize([1, 33, 7, 64, 31, 97, 2, 300], n)
        d = np.tile(np.repeat(np.arange(1, n + 1) % 256, lengths)[:n],
                    (rows, 1))
    else:
        assert case == "one bucket holds a whole row"
        d = np.concatenate([np.zeros((rows, 5), int),
                            np.full((rows, n - 5), 200)], axis=1)
    perm = rng.integers(0, 1 << 16, (rows, n))
    return (torch.tensor(perm, dtype=torch.int32),
            torch.tensor(np.sort(d, axis=1), dtype=torch.uint8))


@pytest.fixture(scope="module")
def path_points(dev):
    n = 1 << 16
    pts, _, _ = _instance(256, 5)
    return tcv.g1_double_plain(pts).to(dev).repeat(n // 256, 1, 1)


@pytest.mark.parametrize("case", ["uniform", "all-ones",
                                  "runs that cross tile edges",
                                  "one bucket holds a whole row"])
@pytest.mark.parametrize("n", [512, 8192])
def test_msm_buckets_kernel_equals_plain_limb_for_limb(dev, path_points,
                                                       case, n):
    """512 rows of n entries (8192: the main path's rows, 2 MSMs of 2^16
    scalars in 8 point groups) against the plain version on the card."""
    perm, digits = _sorted_rows(case, n, 512, np.random.default_rng(8))
    perm, digits = perm.to(dev), digits.to(dev)
    got = kernels.msm_buckets(path_points, perm, digits)
    assert got.shape == (512, 256, 3, 12)
    assert torch.equal(got, tmsm.msm_buckets_plain(path_points, perm,
                                                   digits))
    assert torch.equal(got[:, 0], tcv.g1_infinity((512,), dev))


def test_msm_buckets_kernel_on_short_and_padded_rows(dev):
    """Rows shorter than the block (37 points, 2 groups of 19: one entry a
    thread, most threads idle) and the padded last group, against the
    plain version on the CPU."""
    pts, dlogs, ks = _instance(37, 9)
    ks[20:] = [0x0101] * 17
    perm, digits = tmsm.bucket_runs(tcv.fr_to_scalar_limbs(ks), 2)
    got = kernels.msm_buckets(pts.to(dev), perm.to(dev), digits.to(dev))
    assert torch.equal(got.cpu(), tmsm.msm_buckets_plain(pts, perm, digits))


def test_point_kernels_refuse_what_they_do_not_take(dev, path_points):
    p = path_points[:8].contiguous()
    perm = torch.zeros((4, 16), dtype=torch.int32, device=dev)
    digits = torch.zeros((4, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.g1_add(p.cpu(), p.cpu())
    with pytest.raises(ValueError):
        kernels.g1_add(p, p[:4])                           # shapes differ
    with pytest.raises(ValueError):
        kernels.g1_double(p[..., :8].contiguous())         # not (..., 3, 12)
    flat = torch.zeros(8 * 36 + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.g1_double(flat[1:].view(8, 3, 12))      # 4 bytes in
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.msm_buckets(p, perm.cpu(), digits.cpu())
    with pytest.raises(ValueError):
        kernels.msm_buckets(p, perm, digits.to(torch.int32))   # not uint8
    with pytest.raises(ValueError):
        kernels.msm_buckets(p, perm, digits[:, :8].contiguous())
    with pytest.raises(ValueError):
        kernels.msm_buckets(p, perm.t(), digits.t())       # not contiguous
    # K1 and K2 read points as 4-byte words: a view 4 bytes into its
    # storage is taken, and computed right
    flat = torch.zeros(8 * 36 + 1, dtype=torch.int32, device=dev)
    skewed = flat[1:].view(8, 3, 12)
    skewed.copy_(p)
    assert torch.equal(kernels.g1_add(skewed, p), kernels.g1_add(p, p))


# -- the opening's K3 kernels and the K1 ladder ---------------------------------

def _edge_fr(seed, n):
    """n Fr values (Montgomery) from a seed, the first three 0, 1, r − 1."""
    return FR.encode(_field_values(FR.p, seed, max(n, 3))[:n])


def test_fr_inv_kernel_matches_plain(dev):
    """0, 1, r − 1, r − 2, the limbs 1 (the input whose closing product
    takes a doubling first), the 16 differences β − ω^i of the
    aggregation, and random values, limb for limb against the plain
    version (the same binary inverse on Python integers) and Fermat."""
    from zkp_subnet_tpu_torch.models import pianist
    a = torch.cat([_edge_fr(21, 200), FR.encode([o.R - 2]),
                   FR.ints_to_limbs([1])])
    dom, _ = pianist.aggregation_constants(16)
    diffs = FR.sub(a[100], dom)
    for x in (a, diffs, a[1:2], a[:1], a[-1:]):
        got = kernels.fr_inv(x.to(dev)).cpu()
        assert torch.equal(got, fr_inv_plain(x))
    assert FR.decode(kernels.fr_inv(a.to(dev))) == [
        pow(v, o.R - 2, o.R) for v in FR.decode(a)]


@pytest.mark.parametrize("n", [1, 1000, 4097, 70000])
def test_fr_powers_kernel_matches_plain(dev, n):
    """fr_power_tables (x and 1/x; one, two and three levels) and fr_powers
    (no c, one row of c, four rows) against their plain versions, limb for
    limb, at x 0, 1, r − 1 and random."""
    c = _edge_fr(22, n)
    rows = torch.stack([c, c.roll(1, 0), c.flip(0), c.roll(7, 0)])
    for x in _edge_fr(23, 4):                  # 0, 1, r − 1, random
        x = x.contiguous()
        xd = x.to(dev)
        tables = kernels.fr_power_tables(xd, n, kernels.fr_inv(xd))
        want = fr_power_tables_plain(x, n, fr_inv_plain(x))
        assert torch.equal(tables.cpu(), want)
        assert torch.equal(kernels.fr_power_tables(xd, n).cpu(), want[:1])
        table = tables[0]
        assert torch.equal(kernels.fr_powers(table, n).cpu(),
                           fr_powers_plain(want[0], n))
        assert torch.equal(kernels.fr_powers(table, n, c.to(dev)).cpu(),
                           fr_powers_plain(want[0], n, c))
        assert torch.equal(kernels.fr_powers(table, n, rows.to(dev)).cpu(),
                           fr_powers_plain(want[0], n, rows))


@pytest.mark.parametrize("n", [1, 511, 512, 513, 1000, 1024, 3000,
                               1 << 16, 70000])
def test_opening_kernels_match_plain(dev, n):
    """fr_suffix_scan and fr_open_quotient each against its plain version
    on the same inputs (tiles of the kernel's SCAN_TILE = 512: one partial
    tile, one full, one element past it, two with a partial last, two
    full (a default row of 1024), six with a partial last, 128 full, three
    levels of the table),
    at x 0, 1, r − 1 and random, one row and four at once (the scan on the
    rows laid end to end where they are whole tiles); and a row of zeros.
    The plain versions run on the card."""
    rows = [_edge_fr(24, n).to(dev), FR.zeros((n,), dev)]
    rows.append(torch.stack([rows[0], rows[1], rows[0].flip(0),
                             rows[0].roll(5, 0)]))
    for c in rows:
        local, totals = tpoly._scan_on_card(c if c.dim() == 3 else c[None])
        want = tpoly.fr_suffix_scan_plain(c)
        if c.dim() == 2:
            local, totals = local[0], totals[0]
        assert torch.equal(local, want[0]) and torch.equal(totals, want[1])
        for x in _edge_fr(25, 4).to(dev):
            tables = kernels.fr_power_tables(x, n, kernels.fr_inv(x))
            got = kernels.fr_open_quotient(local, totals, x, tables[1], c)
            want = tpoly.fr_open_quotient_plain(local, totals, x, tables[1],
                                                c)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            if n <= 3000:      # against the CPU's composition
                y, q = tpoly.poly_open_scalars(c, x)
                wy, wq = tpoly.poly_open_scalars(c.cpu(), x.cpu())
                assert torch.equal(y.cpu(), wy) and torch.equal(q.cpu(), wq)


@pytest.mark.parametrize("n", [1, 1000, 3000])
def test_eval_and_quotient_on_card_match_cpu(dev, n):
    """poly_eval (one fr_eval_rows) and poly_eval_and_quotient (the
    opening's four kernels; the quotient back to Montgomery form by one
    fr_mul) on the card against the CPU, limb for limb, at x 0, 1, r − 1
    and random."""
    c = _edge_fr(30, n)
    for x in _edge_fr(31, 4):
        x = x.contiguous()
        before = dict(kernels.LAUNCHES)
        y = tpoly.poly_eval(c.to(dev), x.to(dev))
        used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
        assert used == {"fr_eval_rows": 1}
        assert torch.equal(y.cpu(), tpoly.poly_eval(c, x))
        y, q = tpoly.poly_eval_and_quotient(c.to(dev), x.to(dev))
        wy, wq = tpoly.poly_eval_and_quotient(c, x)
        assert torch.equal(y.cpu(), wy) and torch.equal(q.cpu(), wq)


def test_opening_reads_nothing_back_and_launches_four_kernels(dev):
    """One row: fr_inv, the tables, the powers and the two scan passes, one
    launch each; four rows of 2^12 at one x, with 1/x handed in: the same
    but fr_inv, one launch each (the scan over the rows end to end), four
    of the scan at 3000 (no whole tiles: once a row)."""
    c = _edge_fr(26, 3000).to(dev)
    x = _edge_fr(27, 4)[3].contiguous().to(dev)
    opening = {"fr_power_tables": 1, "fr_powers": 1, "fr_suffix_scan": 1,
               "fr_open_quotient": 1}

    def launches(*args):
        before = dict(kernels.LAUNCHES)
        out = tpoly.poly_open_scalars(*args)
        return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
    (y, q), used = launches(c, x)
    assert used == {"fr_inv": 1, **opening}
    assert FR.decode(y) == [o.poly_eval(FR.decode(c), FR.decode(x)[0])]
    xi = kernels.fr_inv(x)
    for n, scans in ((1 << 12, 1), (3000, 4)):
        rows = _edge_fr(28, 4 * n).view(4, n, 8).to(dev)
        (y, q), used = launches(rows, x, xi)
        assert used == {**opening, "fr_suffix_scan": scans}
        for b in range(4):
            wy, wq = tpoly.poly_open_scalars(rows[b], x)
            assert torch.equal(y[b], wy) and torch.equal(q[b], wq)


#: scalars the ladder is held to beside random ones: 0, 1, r − 1, r − 2;
#: every 4-bit window 8; a carry through all 64 windows and out of the top;
#: 2^256 − 1
EIGHTS = int("8" * 64, 16)
LADDER_EDGES = [0, 1, o.R - 1, o.R - 2, EIGHTS, EIGHTS + 1, (1 << 256) - 1]


def _scalar_limbs(ks, device):
    """Any 256-bit scalars → (N, 8) int32 limbs."""
    return torch.from_numpy(np.frombuffer(
        b"".join(k.to_bytes(32, "little") for k in ks), "<i4").reshape(
            len(ks), 8).copy()).to(device)


@pytest.mark.parametrize("n", [1, 16, 33, 1000, 2048,
                               kernels.LADDER_GROUP_MAX,
                               kernels.LADDER_GROUP_MAX + 1])
def test_g1_scalar_mul_kernel_matches_plain(dev, n):
    """Scalars 0, 1, r − 1, r − 2, every window 8, a carry through every
    window, 2^256 − 1 and random ones, the point at infinity among the
    bases, limb for limb against the plain ladder (on the card) and one
    launch for the whole ladder: n = 1, 16, 33, 1000, a default request's
    2048 and each side of the crossover of the group form (n ≤
    LADDER_GROUP_MAX) and the thread form; both forms equal at every n."""
    m = min(n, 64)
    pts, dlogs, ks = _instance(m, 28)
    pts = tcv.g1_double_plain(pts)              # Z ≠ 1
    ks[:len(LADDER_EDGES)] = LADDER_EDGES
    ks = ks[:m]
    if m > 3:
        pts[3] = tcv.g1_infinity(())
        dlogs[3] = 0
    reps = -(-n // m)
    p = pts.to(dev).repeat(reps, 1, 1)[:n].contiguous()
    rng = np.random.default_rng(n)
    ks_all = (ks + [int.from_bytes(rng.bytes(32), "little")
                    for _ in range(n - m)])[:n]
    sc = _scalar_limbs(ks_all, dev)
    before = dict(kernels.LAUNCHES)
    got = tcv.g1_scalar_mul(p, sc)
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    assert used == {"g1_scalar_mul": 1}
    assert torch.equal(got, tcv.g1_scalar_mul_plain(p, sc))
    other = kernels._ladder(p, sc, not kernels.ladder_grouped(n))
    assert torch.equal(other, got)
    want = [o.G1.to_affine(o.G1.mul(G, 2 * d * k % o.R))
            for d, k in zip(dlogs[:8], ks[:8])]
    if m > 3:
        want[3] = None
    assert tcv.g1_affine(got[:8]) == want


def test_default_request_launches_one_ladder_and_one_tree(dev):
    """A worker of the default configuration's row (scale 18, machines
    scale 8: 1024 coefficients) serves commit+open with one launch of the
    ladder (its group form: 2 × 1024 products), no K2 kernel, and one tree
    of log2(1024) = 10 g1_add launches for both MSMs' sums; the proof
    verifies."""
    srs = Srs.generate(10, 0, seed=3, device=dev)
    worker = Worker(srs)
    rng = np.random.default_rng(5)
    row = [int.from_bytes(rng.bytes(40), "little") % o.R
           for _ in range(1024)]
    req = Prove(index=0, poly=enc.poly_to_b64(row), alpha=enc.fr_to_b64(99))
    worker.forward(req)
    before = dict(kernels.LAUNCHES)
    resp = worker.forward(req)
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    assert used["g1_scalar_mul"] == 1 and kernels.ladder_grouped(2048)
    assert used["g1_add"] == 10
    assert not {"msm_buckets", "msm_reduce", "msm_combine"} & set(used)
    assert worker.worker_verify(0, resp.proof, resp.alpha, resp.eval_,
                                resp.commitment)


@pytest.mark.parametrize("m", [1, 3, 16, 17, 256, 1024])
def test_g1_msm_fixed_kernel_matches_plain(dev, m):
    """The aggregation's MSMs: K1 g1_fixed_table and g1_msm_fixed (3 MSMs
    in one call) limb for limb against their plain versions on the card,
    and against the oracle and msm_naive: a base at infinity (from 4
    keys), Z ≠ 1, scalars 0, 1, r − 1, r − 2 and random; M = 1 and 3 (a
    lone short block in the last launch, of 2 and of 6 padded with
    infinity to 8), 17 (a short block, then a launch of two), 16, 256 and
    1024 (machines_scale 10: once refused past 512);
    one call of each wrapper (the MSM's tree of launches counted as one
    call)."""
    pts, dlogs, ks = _instance(m, 31)
    pts = tcv.g1_double_plain(pts).to(dev)              # Z ≠ 1
    dlogs = [2 * d % o.R for d in dlogs]
    if m > 3:
        pts[3] = tcv.g1_infinity((), dev)
        dlogs[3] = 0
    rows = [([0, 1, o.R - 1, o.R - 2] + ks[4:])[:m], ks[::-1], [o.R - 1] * m]
    sc = torch.stack([tcv.fr_to_scalar_limbs(k, dev) for k in rows])
    before = dict(kernels.LAUNCHES)
    table = tmsm.fixed_table(pts)
    got = tmsm.msm_fixed(table, sc)
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    assert used == {"g1_fixed_table": 1, "g1_msm_fixed": 1}
    assert torch.equal(table, tmsm.fixed_table_plain(pts))
    assert torch.equal(got, tmsm.msm_fixed_plain(table, sc))
    for c, k in enumerate(rows):
        assert tcv.g1_affine(got[c]) == [o.G1.to_affine(o.G1.mul(
            G, sum(a * b for a, b in zip(k, dlogs)) % o.R))], c
    assert tcv.g1_affine(tmsm.msm_naive(pts, sc[0])) == \
        tcv.g1_affine(got[0])


def test_new_kernels_refuse_what_they_do_not_take(dev):
    """Misaligned (16-byte words), non-contiguous and wrongly typed tensors
    are refused by the opening's kernels; the ladder reads 4-byte words, so
    a view 4 bytes into its storage is taken and computed right."""
    c = _edge_fr(29, 64).to(dev)
    x = c[5].contiguous()
    flat = torch.zeros(64 * 8 + 1, dtype=torch.int32, device=dev)
    skewed = flat[1:].view(64, 8)
    skewed.copy_(c)
    strided = torch.zeros((64, 16), dtype=torch.int32, device=dev)[:, :8]
    local, totals = kernels.fr_suffix_scan(c)
    tables = kernels.fr_power_tables(x, 64, x)
    table, xi_table = tables[0], tables[1]
    for bad in (skewed, strided, c.to(torch.int64)):
        exc = ValueError
        with pytest.raises(exc):
            kernels.fr_inv(bad)
        with pytest.raises(exc):
            kernels.fr_suffix_scan(bad)
        with pytest.raises(exc):
            kernels.fr_powers(table, 64, bad)
        with pytest.raises(exc):
            kernels.fr_open_quotient(bad, totals, x, xi_table, c)
        with pytest.raises(exc):
            kernels.fr_open_quotient(local, totals, x, xi_table, bad)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.fr_power_tables(skewed[0], 64)
    with pytest.raises(ValueError):
        kernels.fr_power_tables(c[:2], 64)                 # two elements
    with pytest.raises(ValueError):
        kernels.fr_open_quotient(local, totals[:0], x, xi_table, c)
    # B rows: totals or coeffs of another B, a table of too few levels (one
    # level reaches 256 powers), a table of another width or rank
    rows = torch.stack([c, c]).contiguous()
    local2 = torch.stack([local, local]).contiguous()
    totals2 = torch.stack([totals, totals]).contiguous()
    with pytest.raises(ValueError):
        kernels.fr_open_quotient(local2, totals, x, xi_table, rows)
    with pytest.raises(ValueError):
        kernels.fr_open_quotient(local2, totals2, x, xi_table, c)
    with pytest.raises(ValueError):
        kernels.fr_open_quotient(local2, totals2[:1], x, xi_table, rows[:1])
    long_row = _edge_fr(29, 300).to(dev)
    with pytest.raises(ValueError, match="levels"):
        kernels.fr_powers(table, 300, long_row)
    l300, t300 = kernels.fr_suffix_scan(long_row)
    with pytest.raises(ValueError, match="levels"):
        kernels.fr_open_quotient(l300, t300, x, xi_table, long_row)
    with pytest.raises(ValueError):
        kernels.fr_powers(table[:, :128].contiguous(), 64)
    with pytest.raises(ValueError):
        kernels.fr_powers(tables, 64)
    with pytest.raises(ValueError):
        kernels.fr_powers(table, 64, rows[:, :32].contiguous())
    p = tcv.g1_infinity((8,), dev)
    sc = tcv.fr_to_scalar_limbs(list(range(8)), dev)
    with pytest.raises(ValueError):
        kernels.g1_scalar_mul(p, sc[:4])                   # shapes differ
    with pytest.raises(ValueError):
        kernels.g1_scalar_mul(p, sc.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.g1_scalar_mul(p.transpose(1, 2), sc)       # not contiguous
    pts = tcv.g1_double_plain(_instance(8, 30)[0]).to(dev)
    pflat = torch.zeros(8 * 36 + 1, dtype=torch.int32, device=dev)
    pskew = pflat[1:].view(8, 3, 12)
    pskew.copy_(pts)
    assert torch.equal(kernels.g1_scalar_mul(pskew, sc),
                       kernels.g1_scalar_mul(pts, sc))
    table = kernels.g1_fixed_table(pts)
    with pytest.raises(ValueError):
        kernels.g1_msm_fixed(table, sc[None, :4])          # 4 scalars, 8 keys
    with pytest.raises(ValueError):
        kernels.g1_msm_fixed(table[:, :8], sc[None])       # 8 windows
    with pytest.raises(ValueError):
        kernels.g1_msm_fixed(table, sc[None].to(torch.int64))
    # 1024 keys (refused past 512 before): the table of the 8 keys, each
    # repeated 128 times, is the table of the 1024
    many = 1024
    wide = table.repeat(many // 8, 1, 1, 1, 1)
    wsc = tcv.fr_to_scalar_limbs(list(range(many)), dev)[None]
    assert torch.equal(kernels.g1_msm_fixed(wide, wsc),
                       tmsm.msm_fixed_plain(wide, wsc))
    with pytest.raises(ValueError):
        kernels.g1_fixed_table(pts[None])


@pytest.mark.parametrize("rows, n, shared", [
    (4, 1, None), (4, 1000, None), (4, 1024, None), (4, 1025, None),
    (4, 2048, None), (4, 2049, "x"), (4, 3000, "x"), (1, 3000, None),
    (16, 3000, "row"), (16, 1 << 16, "x"), (16, 1 << 16, "row"),
    (3, 34 * 2048 + 5, None)])
def test_fr_eval_rows_kernel_matches_plain(dev, rows, n, shared):
    """K3 fr_eval_rows against its plain version limb for limb: x = 0, 1,
    r − 1 and random (each row its point, or all rows one point), a row of
    zeros, one row at many points, n of one element, one tile
    (EVAL_TILE = 2048), one element past it, no multiple of the tile and
    more than 32 tiles (the second pass's Horner steps); at the
    challenge's 16 × 2^16 and one 2^16 row at 16 points, one launch and
    the oracle for row 0. The plain version runs on the card past 3000."""
    c = _edge_fr(40 + n, rows * n).view(rows, n, 8).clone()
    c[1 % rows] = 0
    xs = _edge_fr(41, max(rows, 4))[:rows].clone()
    if shared == "x":
        xs = xs[3:4].contiguous()
    if shared == "row":
        c = c[2:3].contiguous()
    before = dict(kernels.LAUNCHES)
    got = kernels.fr_eval_rows(c.to(dev), xs.to(dev))
    assert kernels.LAUNCHES["fr_eval_rows"] == before["fr_eval_rows"] + 1
    on = (lambda t: t) if n <= 3000 else (lambda t: t.to(dev))
    want = tpoly.fr_eval_rows_plain(on(c), on(xs))
    assert torch.equal(got.cpu(), want.cpu())
    if n > 3000:
        assert FR.decode(got[:1]) == [o.poly_eval(FR.decode(c[0]),
                                                  FR.decode(xs[0])[0])]


@pytest.mark.parametrize("rows", [600, 1100])
def test_fr_eval_rows_many_rows_at_one_point(dev, rows):
    """K3 fr_eval_rows over many rows of two tiles (2049 coefficients) at
    one random point: on a card of 132 SMs a block takes two rows at 600
    rows and four at 1100 (the most that leave four blocks an SM), the
    last block fewer; limb for limb to the plain version on the card."""
    rng = np.random.default_rng(46 + rows)
    limbs = rng.integers(0, 1 << 16, (rows, 2049, 16), dtype=np.uint32)
    limbs[..., 15] %= 0x73ED                     # below r
    c = FR.from_limbs16(limbs, dev)
    x = _edge_fr(47, 4)[3:4].contiguous().to(dev)
    assert torch.equal(kernels.fr_eval_rows(c, x),
                       tpoly.fr_eval_rows_plain(c, x))


def test_fr_eval_rows_short_rows_match_plain(dev):
    """K3 fr_eval_rows at every n from 1 to 33 (a lane's run of one Horner
    step, then two): four rows each at its own x of 0, 1, r − 1 and random,
    the four at one x, and one row at the four points, limb for limb to
    the plain version."""
    xs = _edge_fr(44, 4)
    for n in range(1, 34):
        c = _edge_fr(45 + n, 4 * n).view(4, n, 8)
        for cc, xx in ((c, xs), (c, xs[3:4]), (c[2:3], xs)):
            got = kernels.fr_eval_rows(cc.contiguous().to(dev),
                                       xx.contiguous().to(dev))
            assert torch.equal(got.cpu(), tpoly.fr_eval_rows_plain(cc, xx)), n


def test_fr_eval_rows_refuses_what_it_does_not_take(dev):
    c = _edge_fr(42, 4 * 64).view(4, 64, 8).to(dev)
    xs = _edge_fr(43, 4).to(dev)
    flat = torch.zeros(4 * 64 * 8 + 1, dtype=torch.int32, device=dev)
    skewed = flat[1:].view(4, 64, 8)
    for bad_c, bad_x in ((skewed, xs), (c[:3], xs), (c, xs[:3]),
                         (c[0], xs), (c, xs.to(torch.int64)),
                         (c.transpose(0, 1), xs)):
        with pytest.raises(ValueError):
            kernels.fr_eval_rows(bad_c, bad_x)
    assert not kernels.fr_eval_rows(c[:, :0].contiguous(), xs).any()


def test_coordinator_and_server_take_the_card_by_default(dev, tmp_path):
    """An SRS made with no device named is on the card, and so are the
    coordinator's draws and the server's: the challenge's evals by one
    fr_eval_rows and no fr_inv, a round through LocalTransport and one
    through HttpTransport with every reward > 0, the aggregation verifies,
    and the state file loads back."""
    srs = Srs.generate(6, 2, tau_x=11, tau_y=13)
    assert srs.device.type == "cuda"
    hotkeys = [f"hk{i}" for i in range(4)]
    cfg = trt.CoordinatorConfig(sample_size=4, timeout=600.0,
                                state_dir=str(tmp_path))
    coord = trt.Coordinator(srs, cfg, hotkeys, seed=1)
    assert coord.generator.device.type == "cuda"
    before = dict(kernels.LAUNCHES)
    ch = coord.generate_challenge(4)
    assert kernels.LAUNCHES["fr_eval_rows"] - before["fr_eval_rows"] == 1
    assert kernels.LAUNCHES["fr_inv"] == before["fr_inv"]
    assert [enc.fr_from_b64(e) for e in ch.evals] == [
        o.poly_eval(enc.poly_from_b64(p), enc.fr_from_b64(ch.alpha))
        for p in ch.polys]
    workers = {u: trt.Worker(srs) for u in range(4)}
    ch, responses, rewards = coord.run_round(trt.LocalTransport(workers))
    assert all(r.commitment and r.proof for r in responses)
    assert (rewards > 0).all()
    agg, alpha, beta = coord.aggregate_responses(ch, responses)
    assert coord.verify_aggregated(agg, alpha, beta)
    server = trt.WorkerServer(workers[0], port=0).start()
    try:
        assert server._generator.device.type == "cuda"
        point = rpc(server.url, "random_point", {})["point"]
        assert 0 <= enc.fr_from_b64(point) < o.R
        ch, responses, rewards = coord.run_round(
            trt.HttpTransport({u: server.url for u in range(4)}))
        assert (rewards > 0).all()
    finally:
        server.stop()
    coord.save_state()
    fresh = trt.Coordinator(srs, cfg, [])
    assert fresh.load_state() and fresh.step == 2
    assert np.array_equal(fresh.scores, coord.scores)


def test_one_rank_nccl_prove_matches_cpu_prove(dev):
    """The multi-device prove as one NCCL rank on the card (the world
    ``make_mesh`` starts when none is) equals the same prove as one gloo
    rank on the CPU, on the session size (scale 6 / machines_scale 2), two
    challenges at once, and the same rows, α and β; so do the NTT's both
    axes."""
    import torch.distributed as dist
    from zkp_subnet_tpu_torch.models import pianist as pn
    from zkp_subnet_tpu_torch.parallel import pianist as par
    srs = Srs.generate(6, 2, seed=3, device="cpu")
    g = torch.Generator().manual_seed(7)
    rows = pn._uniform_fr(g, (2, srs.machines, srs.row_size))
    alpha, beta = pn.random_point(g), pn._uniform_fr(g, (2,))
    got = {}
    for device in (None, "cpu"):
        mesh = par.make_mesh(device=device)
        try:
            backend = dist.get_backend()
            d = par.mesh_device(mesh)
            assert (d.type, backend) == (("cpu", "gloo") if device
                                         else ("cuda", "nccl"))
            out = par.prove(par.shard_srs(srs, mesh), rows.to(d),
                            alpha.to(d), beta.to(d), mesh)
            ffts = [par.fft(rows.to(d), mesh, left=left, inverse=inverse)
                    for left in (True, False) for inverse in (False, True)]
            got[d.type] = [x.cpu() for x in (*out, *ffts)]
        finally:
            dist.destroy_process_group()
    for card, cpu in zip(got["cuda"], got["cpu"]):
        if card.shape[-2:] == (3, FQ.L):
            assert tcv.g1_affine(card) == tcv.g1_affine(cpu)
        else:
            assert FR.decode(card) == FR.decode(cpu)
