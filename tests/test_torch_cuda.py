"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); without one every test here skips.
The module imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none (integer arithmetic; points compared as affine points).
"""

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch._shared import encoding as enc
from zkp_subnet_tpu_torch._shared import oracle as o
from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops.field import FR
from zkp_subnet_tpu_torch.runtime.worker import Prove, Worker

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
