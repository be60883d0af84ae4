"""The port's aggregation and many-row openings call their kernels once:
``parallel.pianist.commit_open`` inverts its shared α once for all rows,
and ``pianist.aggregate_core`` makes one ``msm_fixed`` call (K1
``g1_msm_fixed`` on the card) for C_y and W_y of every challenge and one
inverse for all their differences, and never the ladder. Counted on the
CPU by wrapping the dispatching functions (the card's launch counts are
``chip_smoke.py``'s); the values are held to the per-row and per-challenge
calls, limb for limb. Tolerance: none (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch.models import pianist as pn
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import poly as tpoly
from zkp_subnet_tpu_torch.ops.field import FR
from zkp_subnet_tpu_torch.parallel import pianist as par
from zkp_subnet_tpu_torch.utils import oracle as o

M = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fr(rng, shape):
    vals = [int.from_bytes(rng.bytes(40), "little") % o.R
            for _ in range(int(np.prod(shape)))]
    return FR.encode(vals).view(*shape, FR.L)


def _points(rng, n):
    g = o.G1.from_affine(o.G1_GEN)
    return tcv.g1_encode([o.G1.mul(g, int(k)) for k in
                          rng.integers(1, 1 << 62, n)])


def _counting(monkeypatch, owner, name):
    calls = []
    real = getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(owner, name, spy)
    return calls


def test_commit_open_inverts_alpha_once(monkeypatch):
    """Bl·Ml = 4 rows opened at one α: one ``FR.inv`` (one K3 ``fr_inv`` on
    the card, where each opening inverted α for itself before), and the
    evals and quotients of each row's own opening. The MSMs are stubbed:
    what goes into them is held to the per-row openings."""
    rng = np.random.default_rng(3)
    bl, ml, t = 2, 2, 8
    rows, alpha = _fr(rng, (bl, ml, t)), _fr(rng, (1,))[0]
    seen = {}

    def msm_stub(bases, scalars):
        seen["scalars"] = scalars
        return tcv.g1_infinity(scalars.shape[:2])
    monkeypatch.setattr(tmsm, "msm_auto_groups", msm_stub)
    inv = _counting(monkeypatch, FR, "inv")
    _, evals, _ = par.commit_open(tcv.g1_infinity((ml, t)), rows, alpha)
    assert len(inv) == 1
    monkeypatch.undo()
    for b in range(bl):
        for i in range(ml):
            y, q = tpoly.poly_open_scalars(rows[b, i], alpha)
            assert torch.equal(evals[b, i], y)
            assert torch.equal(seen["scalars"][i, bl + b], q)


def test_open_all_inverts_x_once(monkeypatch):
    """``pianist.open_all`` over M rows at one x: one ``FR.inv``."""
    rng = np.random.default_rng(5)
    rows, x = _fr(rng, (M, 8)), _fr(rng, (1,))[0]
    monkeypatch.setattr(tmsm, "msm_auto_many",
                        lambda b, s: tcv.g1_infinity(s.shape[:1]))
    srs = type("S", (), {"device_worker_bases":
                         lambda self, i: tcv.g1_infinity((8,))})()
    inv = _counting(monkeypatch, FR, "inv")
    ys, _ = pn.open_all(srs, rows, x)
    assert len(inv) == 1
    monkeypatch.undo()
    assert torch.equal(ys, torch.stack(
        [tpoly.poly_open_scalars(r, x)[0] for r in rows]))


def test_aggregate_core_one_msm_call_one_inverse(monkeypatch):
    """Two challenges through one ``aggregate_core``: one ``msm_fixed`` call
    for the 2·2 Lagrange-Y MSMs, one ``FR.inv``, no ladder and no naive or
    Pippenger MSM; and each output equal, limb for limb, to that
    challenge's aggregation alone."""
    rng = np.random.default_rng(7)
    b = 2
    table = tmsm.fixed_table(_points(rng, M))
    coms = _points(rng, b * M).view(b, M, 3, 12)
    prfs = _points(rng, b * M).view(b, M, 3, 12)
    evals, beta = _fr(rng, (b, M)), _fr(rng, (b,))
    dom, m_inv = pn.aggregation_constants(M)
    msm = _counting(monkeypatch, tmsm, "msm_fixed")
    inv = _counting(monkeypatch, FR, "inv")
    for owner, name in ((tmsm, "msm_auto"), (tmsm, "msm_naive"),
                        (tmsm, "msm_many"), (tcv, "g1_scalar_mul")):
        monkeypatch.setattr(owner, name, None)
    both = pn.aggregate_core(table, coms, prfs, evals, beta, dom, m_inv)
    assert (len(msm), len(inv)) == (1, 1)
    assert msm[0][1].shape == (2 * b, M, FR.L)
    for c in range(b):
        one = pn.aggregate_core(table, coms[c:c + 1], prfs[c:c + 1],
                                evals[c:c + 1], beta[c:c + 1], dom, m_inv)
        for x, y in zip(both, one):
            assert torch.equal(x[c], y[0])


def test_aggregate_core_at_1024_keys_matches_oracle():
    """The aggregation at machines_scale 10 (M = 1024 workers, one
    challenge, evals 0, 1, r − 1 and random, β random, one key at
    infinity), once refused past 512 keys: C = Σ C_i,
    W = Σ W_i, the value y(β) (the oracle's inverse NTT of the evals, then
    Horner at β), C_y = Σ y_i·V_i and W_y = Σ q_i·V_i with q_i = (y_i −
    y(β))/(ω^i − β), against the oracle. The keys are 16 points of known
    dlog, each 64 times (a key's table rows depend on that key alone, so
    the table of the 16, repeated, is the table of the 1024); the MSMs'
    terms cross all four launches of ``msm_fixed``'s tree (65,536 → 2,048
    → 64 → 2 → 1). The JAX package's ``aggregate_core`` is not run here:
    at M = 1024 it runs 1024 ladders eagerly on the CPU."""
    rng = np.random.default_rng(11)
    m, reps = 1024, 64
    g = o.G1.from_affine(o.G1_GEN)
    vs = [int(v) for v in rng.integers(1, 1 << 62, m // reps)]
    keys = tcv.g1_encode([o.G1.mul(g, v) for v in vs])
    vs[5] = 0                              # key 5 (and 21, 37, …) infinity
    keys[5] = tcv.g1_infinity(())
    table = tmsm.fixed_table(keys).repeat(reps, 1, 1, 1, 1)
    cs = [int(v) for v in rng.integers(1, 1 << 62, 2 * m // reps)]
    coms, prfs = (tcv.g1_encode([o.G1.mul(g, c) for c in half]).repeat(
        reps, 1, 1)[None] for half in (cs[:m // reps], cs[m // reps:]))
    ys = [0, 1, o.R - 1] + [int.from_bytes(rng.bytes(40), "little") % o.R
                            for _ in range(m - 3)]
    beta = int.from_bytes(rng.bytes(40), "little") % o.R
    dom, m_inv = pn.aggregation_constants(m)
    C, W, C_y, W_y, value = (x[0] for x in pn.aggregate_core(
        table, coms, prfs, FR.encode(ys)[None], FR.encode([beta]), dom,
        m_inv))

    def want(dlog):
        return [o.G1.to_affine(o.G1.mul(g, dlog % o.R))]
    v = o.poly_eval(o.intt(ys), beta)
    assert FR.decode(value[None]) == [v]
    w = o.fr_root_of_unity(10)
    qs = [(y - v) * pow((pow(w, i, o.R) - beta) % o.R, o.R - 2, o.R) % o.R
          for i, y in enumerate(ys)]
    key = [vs[i % len(vs)] for i in range(m)]
    assert tcv.g1_affine(C_y) == want(sum(y * k for y, k in zip(ys, key)))
    assert tcv.g1_affine(W_y) == want(sum(q * k for q, k in zip(qs, key)))
    assert tcv.g1_affine(C) == want(reps * sum(cs[:m // reps]))
    assert tcv.g1_affine(W) == want(reps * sum(cs[m // reps:]))
