"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); without one every test here skips.
The module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none (integer arithmetic; points compared as affine points,
``msm_reduce`` and ``msm_combine`` limb for limb).
"""

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import ntt as tntt
from zkp_subnet_tpu_torch.ops.field import FQ, FR
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
    q[0] = p[0]
    q[1] = tcv.g1_neg(p[1:2])[0]
    p[2] = tcv.g1_infinity(())
    got = kernels.g1_add(p.to(dev), q.to(dev)).cpu()
    assert torch.equal(got, tcv.g1_add_plain(p, q))
    got = kernels.g1_double(p.to(dev)).cpu()
    assert torch.equal(got, tcv.g1_double_plain(p))


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
