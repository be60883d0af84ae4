"""The port's SRS generation and Pianist round (zkp_subnet_tpu_torch/models/
srs.py, models/pianist.py) against the JAX package at the toy scale of the
JAX suite (scale 6, machines_scale 2: 4 workers, rows of 16 coefficients).

The shared ``srs`` fixture is the JAX package's SRS for ``TEST_SRS_SEED``.
Rows, α and β come from a numpy seed and cross as numpy arrays in the JAX
boundary format (16-bit-limb uint32, Montgomery). Field values are compared
as integers; SRS points limb for limb in the file format (the comb adds in
the same order); MSM and sum outputs as affine points (the engines and the
add order differ). Tolerance: none (integer arithmetic).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import TEST_MACHINES_SCALE, TEST_SCALE, TEST_SRS_SEED
from zkp_subnet_tpu.models import pianist as jpianist
from zkp_subnet_tpu.models.srs import Srs as JSrs
from zkp_subnet_tpu.ops import curve as jcv
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.models import pianist
from zkp_subnet_tpu_torch.models.srs import (Srs, _lagrange_coeffs_at,
                                             default_paths, to_numpy_points)
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops.field import FR

WB = 8            # the window size the JAX suite compiles its MSMs for
M, T = 1 << TEST_MACHINES_SCALE, 1 << (TEST_SCALE - TEST_MACHINES_SCALE)
G = o.G1.from_affine(o.G1_GEN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fields(jsrs):
    return dict(scale=jsrs.scale, machines_scale=jsrs.machines_scale,
                g1_x=np.asarray(jsrs.g1_x),
                worker_bases=np.asarray(jsrs.worker_bases),
                lagrange_y=np.asarray(jsrs.lagrange_y),
                g2_gen=jsrs.g2_gen, g2_tau_x=jsrs.g2_tau_x,
                g2_tau_y=jsrs.g2_tau_y)


def _same_srs(a: dict, b: dict):
    for k in ("scale", "machines_scale"):
        assert int(a[k]) == int(b[k]), k
    for k in ("g1_x", "worker_bases", "lagrange_y"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for k in ("g2_gen", "g2_tau_x", "g2_tau_y"):
        assert o.G2.to_affine(a[k]) == o.G2.to_affine(b[k]), k


@pytest.fixture(scope="module")
def tsrs():
    return Srs.generate(TEST_SCALE, TEST_MACHINES_SCALE, seed=TEST_SRS_SEED,
                        device="cpu")


@pytest.fixture(scope="module")
def challenge():
    """(rows (M, T) ints, α, β) from a numpy seed."""
    rng = np.random.default_rng(2024)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % o.R  # noqa: E731
    return [[draw() for _ in range(T)] for _ in range(M)], draw(), draw()


@pytest.fixture(scope="module")
def rounds(srs, tsrs, challenge):
    """One round by each package on the same numpy inputs:
    (JAX (coms, ys, proofs, agg), port (coms, ys, proofs, agg))."""
    rows, alpha, beta = challenge
    jrows = JFR.encode_vec([c for r in rows for c in r]).reshape(M, T, JFR.L)
    rows16 = np.asarray(jrows)
    ja, jb = JFR.encode([alpha])[0], JFR.encode([beta])[0]
    jcoms = jpianist.commit_all(srs, jrows, window_bits=WB)
    jys, jprfs = jpianist.open_all(srs, jrows, ja, window_bits=WB)
    jagg = jpianist.aggregate(srs, jcoms, jprfs, jys, jb, window_bits=WB)

    trows = FR.from_limbs16(rows16)
    ta = FR.from_limbs16(np.asarray(ja))
    tb = FR.from_limbs16(np.asarray(jb))
    coms = pianist.commit_all(tsrs, trows)
    ys, prfs = pianist.open_all(tsrs, trows, ta)
    agg = pianist.aggregate(tsrs, coms, prfs, ys, tb)
    return (jcoms, jys, jprfs, jagg), (coms, ys, prfs, agg)


def _jaffine(points):
    return [o.G1.to_affine(p) for p in
            jcv.g1_decode(np.asarray(points).reshape(-1, 3, 24))]


# -- SRS ---------------------------------------------------------------------

def test_generate_equals_jax_srs_in_the_file_format(srs, tsrs):
    """Array for array, limb for limb: same trapdoor draws, same comb."""
    _same_srs(tsrs.to_numpy(), _jax_fields(srs))
    assert (tsrs.machines, tsrs.row_size) == (M, T)
    assert tsrs.worker_bases.shape == (M, T, 3, 12)
    # U_i[0] == V_i (τ_X^0 = 1), and a base against the oracle
    assert torch.equal(tsrs.worker_bases[:, 0], tsrs.lagrange_y)
    import random
    rnd = random.Random(TEST_SRS_SEED + 0x5E70)
    tau_x, tau_y = rnd.randrange(1, o.R), rnd.randrange(1, o.R)
    lag = _lagrange_coeffs_at(tau_y, M)
    want = o.G1.mul(G, lag[2] * pow(tau_x, 5, o.R) % o.R)
    assert tcv.g1_affine(tsrs.worker_bases[2, 5]) == [o.G1.to_affine(want)]
    assert sum(lag) % o.R == 1                      # Σ R_i(τ_Y) = 1


@pytest.mark.parametrize("sidecar", [False, True])
def test_each_package_loads_the_others_files(srs, tsrs, tmp_path,
                                             monkeypatch, sidecar):
    if sidecar:
        monkeypatch.setattr(JSrs, "_SIDE_CAR_LIMIT", 0)
        monkeypatch.setattr(Srs, "_SIDE_CAR_LIMIT", 0)
    want = _jax_fields(srs)
    # the port writes, the JAX package reads
    sp, pp = default_paths(str(tmp_path / "t"), TEST_SCALE,
                           TEST_MACHINES_SCALE)
    os.makedirs(os.path.dirname(sp))
    tsrs.save(sp, pp)
    assert os.path.exists(pp + ".bases.npy") == sidecar
    _same_srs(_jax_fields(JSrs.load(sp, pp)), want)
    # the JAX package writes, the port reads (eagerly and lazily)
    jsp, jpp = str(tmp_path / "js.npz"), str(tmp_path / "jp.npz")
    srs.save(jsp, jpp)
    assert os.path.exists(jpp + ".bases.npy") == sidecar
    _same_srs(Srs.load(jsp, jpp, device="cpu").to_numpy(), want)
    lazy = Srs.load(jsp, jpp, lazy=True, device="cpu")
    assert isinstance(lazy.worker_bases, torch.Tensor) != sidecar
    _same_srs(lazy.to_numpy(), want)
    row = lazy.device_worker_bases(3)
    assert torch.equal(row, tsrs.worker_bases[3])
    assert lazy.device_worker_bases(3) is row or not sidecar
    with pytest.raises(FileNotFoundError):
        Srs.load(jsp, str(tmp_path / "missing.npz"), device="cpu")


def test_generate_to_disk_equals_generate_and_save(tsrs, tmp_path):
    sp, pp = str(tmp_path / "s.npz"), str(tmp_path / "p.npz")
    seen = []
    Srs.generate_to_disk(TEST_SCALE, TEST_MACHINES_SCALE, sp, pp,
                         seed=TEST_SRS_SEED, device="cpu",
                         progress=lambda done, total: seen.append((done,
                                                                   total)))
    assert seen == [(i + 1, M) for i in range(M)]
    assert os.path.exists(pp + ".bases.npy")      # always a sidecar
    _same_srs(Srs.load(sp, pp, device="cpu").to_numpy(), tsrs.to_numpy())
    _same_srs(_jax_fields(JSrs.load(sp, pp)), tsrs.to_numpy())


def test_srs_numpy_carriers_round_trip(srs, tsrs):
    back = Srs.from_numpy(_jax_fields(srs), device="cpu")
    assert torch.equal(back.worker_bases, tsrs.worker_bases)
    assert torch.equal(back.g1_x, tsrs.g1_x)
    assert back.device == torch.device("cpu")
    assert np.array_equal(to_numpy_points(back.lagrange_y),
                          np.asarray(srs.lagrange_y))


# -- the round ---------------------------------------------------------------

def test_commit_all_open_all_match_jax_and_oracle(rounds, challenge):
    rows, alpha, _ = challenge
    (jcoms, jys, jprfs, _), (coms, ys, prfs, _) = rounds
    assert coms.shape == (M, 3, 12) and ys.shape == (M, 8)
    assert FR.decode(ys) == JFR.decode_vec(jys) == \
        [o.poly_eval(r, alpha) for r in rows]
    assert tcv.g1_affine(coms) == _jaffine(jcoms)
    assert tcv.g1_affine(prfs) == _jaffine(jprfs)


def test_worker_programs_and_verify(tsrs, rounds, challenge):
    rows, alpha, _ = challenge
    _, (coms, ys, prfs, _) = rounds
    i = 1
    row = FR.encode(rows[i])
    com = pianist.worker_commit(tsrs, i, row)
    y, prf = pianist.worker_open(tsrs, i, row, FR.encode([alpha])[0])
    assert torch.equal(com, coms[i]) and torch.equal(prf, prfs[i])
    assert torch.equal(y, ys[i])
    com_pt, prf_pt = tcv.g1_decode(com)[0], tcv.g1_decode(prf)[0]
    y_int = FR.decode(y)[0]
    assert pianist.worker_verify(tsrs, i, prf_pt, alpha, y_int, com_pt)
    assert not pianist.worker_verify(tsrs, i, prf_pt, alpha,
                                     (y_int + 1) % o.R, com_pt)
    assert not pianist.worker_verify(tsrs, i, o.G1.add(prf_pt, G), alpha,
                                     y_int, com_pt)


def test_aggregate_matches_jax(rounds, challenge, tsrs):
    rows, alpha, beta = challenge
    (_, _, _, jagg), (_, _, _, agg) = rounds
    assert FR.decode(agg.value) == JFR.decode(jagg.value[None])
    assert FR.decode(agg.evals) == JFR.decode_vec(jagg.evals)
    for name in ("commitment", "proof_x", "commitment_y", "proof_y"):
        assert tcv.g1_affine(getattr(agg, name)) == \
            _jaffine(getattr(jagg, name)), name
    # the aggregated value is f(α, β) = Σ_i R_i(β)·f_i(α)
    lag_b = _lagrange_coeffs_at(beta, M)
    want = sum(lag_b[i] * o.poly_eval(rows[i], alpha) for i in range(M))
    assert FR.decode(agg.value) == [want % o.R]
    dom, m_inv = pianist.aggregation_constants(M)
    w = o.fr_root_of_unity(TEST_MACHINES_SCALE)
    assert FR.decode(dom) == [pow(w, i, o.R) for i in range(M)]
    assert FR.decode(m_inv)[0] * M % o.R == 1


def test_verify_aggregated_and_carriers(srs, tsrs, rounds, challenge):
    """True for the honest proof, False after tampering, in both packages,
    and each package verifies the proof the other made."""
    _, alpha, beta = challenge
    (_, _, _, jagg), (_, _, _, agg) = rounds
    assert pianist.verify_aggregated(tsrs, agg, alpha, beta)
    bad = dataclasses.replace(agg, value=FR.encode([1])[0])
    assert not pianist.verify_aggregated(tsrs, bad, alpha, beta)
    bad = dataclasses.replace(agg, proof_y=agg.proof_x)
    assert not pianist.verify_aggregated(tsrs, bad, alpha, beta)
    assert not pianist.verify_aggregated(tsrs, agg, alpha, (beta + 1) % o.R)
    # JAX's proof through the carrier into the port, and back
    jfields = {f.name: np.asarray(getattr(jagg, f.name))
               for f in dataclasses.fields(jagg)}
    carried = pianist.AggregatedProof.from_numpy(jfields, device="cpu")
    assert pianist.verify_aggregated(tsrs, carried, alpha, beta)
    back = carried.to_numpy()
    assert all(np.array_equal(back[k], jfields[k]) for k in jfields)
    ours = jpianist.AggregatedProof(
        **{k: jnp.asarray(v) for k, v in agg.to_numpy().items()})
    assert jpianist.verify_aggregated(srs, ours, alpha, beta)


def test_tampered_eval_gives_a_rejected_proof(tsrs, rounds, challenge):
    """A proof aggregated from evaluations of which one was changed does not
    verify: C_y no longer matches the workers' commitments."""
    _, alpha, beta = challenge
    _, (coms, ys, prfs, _) = rounds
    bad_ys = ys.clone()
    bad_ys[2] = FR.add(ys[2], FR.ones((), ys.device))
    bad = pianist.aggregate(tsrs, coms, prfs, bad_ys, FR.encode([beta])[0])
    assert not pianist.verify_aggregated(tsrs, bad, alpha, beta)


# -- fft / eval_poly / sampler -------------------------------------------------

@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("inverse", [True, False])
def test_fft_matches_jax_and_oracle(challenge, left, inverse):
    rows, _, _ = challenge
    jrows = JFR.encode_vec([c for r in rows for c in r]).reshape(M, T, JFR.L)
    trows = FR.from_limbs16(np.asarray(jrows))
    got = pianist.fft(trows, left=left, inverse=inverse)
    want = jpianist.fft(jrows, left=left, inverse=inverse)
    assert got.shape == (M, T, 8) and got.is_contiguous()
    assert np.array_equal(FR.to_limbs16(got), np.asarray(want))
    ref = o.intt if inverse else o.ntt
    if left:
        assert FR.decode(got[1]) == ref(rows[1])
    else:
        assert FR.decode(got[:, 3]) == ref([r[3] for r in rows])
    back = pianist.fft(got, left=left, inverse=not inverse)
    assert torch.equal(back, trows)
    # a single row is a plain transform
    assert torch.equal(pianist.fft(trows[0], inverse=inverse),
                       pianist.fft(trows, True, inverse)[0])


def test_eval_poly_matches_jax_and_oracle(rounds, challenge):
    """f_i(α) by ``eval_poly`` equals the evaluations the JAX package's
    ``open_all`` returned for the same rows (limb for limb), and the
    oracle's Horner value."""
    rows, alpha, _ = challenge
    (_, jys, _, _), _ = rounds
    ta = FR.encode([alpha])[0]
    for i in (0, 3):
        got = pianist.eval_poly(FR.encode(rows[i]), ta)
        assert np.array_equal(FR.to_limbs16(got), np.asarray(jys[i]))
        assert FR.decode(got) == [o.poly_eval(rows[i], alpha)]


def test_sampler_is_canonical_and_seeded(tsrs):
    """The port's sampler cannot give ``jax.random``'s draws; it is held to:
    shape, every value canonical (< r), the Montgomery round trip equal to
    the oracle's, and one seed giving one stream."""
    gen = torch.Generator().manual_seed(5)
    rows = pianist.random_poly(tsrs, gen)
    point = pianist.random_point(gen)
    assert rows.shape == (M, T, 8) and point.shape == (8,)
    mont = FR.limbs_to_ints(rows) + FR.limbs_to_ints(point)
    assert all(v < o.R for v in mont)
    canon = FR.limbs_to_ints(FR.from_mont(rows)) + \
        FR.limbs_to_ints(FR.from_mont(point))
    R256 = 1 << 256
    assert [c * R256 % o.R for c in canon] == mont
    assert FR.decode(rows) + FR.decode(point) == canon
    assert len(set(canon)) == len(canon)
    again = pianist.random_poly(tsrs, torch.Generator().manual_seed(5))
    assert torch.equal(again, rows)
    other = pianist.random_poly(tsrs, torch.Generator().manual_seed(6))
    assert not torch.equal(other, rows)
