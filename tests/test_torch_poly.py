"""The port's polynomial pipeline (zkp_subnet_tpu_torch/ops/poly.py) against
the reference golden vectors, the JAX package's poly.py and the oracle.

Rows and points come from a numpy seed; the comparison is on (N, 16) uint32
16-bit limbs (Montgomery for evaluations, canonical for quotient scalars).
Tolerance: none. x = 0 is covered: a commit-only request opens at x = 0.
"""

import jax
import jax.numpy as jnp
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


@pytest.mark.parametrize("n", [16, 256])
def test_open_pieces_plain_match_jax(jax_open, n):
    """The plain versions of the four opening kernels (fr_inv, fr_powers,
    fr_suffix_scan, fr_open_quotient), composed as the card runs them with
    tiles of 32 (one partial tile at 16, eight full ones at 256), against
    the JAX package's poly_open_scalars, limb for limb, at x random, 0, 1
    and r − 1; Montgomery quotients against poly_eval_and_quotient."""
    coeffs = _row(n, n + 2)
    jc = JFR.encode(coeffs)
    c = FR.from_limbs16(np.asarray(jc))
    for point in (_row(1, n + 3)[0], 0, 1, o.R - 1):
        x = FR.encode([point])[0]
        jy, jq = jax_open(jc, JFR.encode([point])[0])
        y, q = tpoly.open_pieces_plain(c, x, tile=32)
        assert np.array_equal(FR.to_limbs16(y), np.asarray(jy)), point
        assert np.array_equal(FR.to_limbs16(q), np.asarray(jq)), point
        wy, wq = tpoly.poly_eval_and_quotient(c, x)
        assert torch.equal(y, wy), point
        assert torch.equal(FR.to_mont(q[:-1]), wq), point
        assert FR.decode(q[-1:]) == [0]


@pytest.mark.parametrize("n", [16, 256])
def test_batched_open_pieces_plain_match_jax_row_by_row(jax_open, n):
    """The plain versions of the opening's kernels over B = 3 rows at one x
    (one table of x and of 1/x for all rows, tiles of 32, level widths 4
    and 8: two levels at n = 16, three and four at 256), against the JAX
    package's poly_open_scalars of each row, limb for limb, at x random, 0,
    1 and r − 1; and against the CPU's batched opening."""
    rows = [_row(n, n + 20 + b) for b in range(3)]
    jcs = [JFR.encode(r) for r in rows]
    c = torch.stack([FR.from_limbs16(np.asarray(jc)) for jc in jcs])
    for point in (_row(1, n + 30)[0], 0, 1, o.R - 1):
        x = FR.encode([point])[0]
        want = [jax_open(jc, JFR.encode([point])[0]) for jc in jcs]
        for width in (4, 8):
            y, q = tpoly.open_pieces_plain(c, x, tile=32, width=width)
            assert y.shape == (3, 8) and q.shape == (3, n, 8)
            for b, (jy, jq) in enumerate(want):
                assert np.array_equal(FR.to_limbs16(y[b]), np.asarray(jy))
                assert np.array_equal(FR.to_limbs16(q[b]), np.asarray(jq))
        wy, wq = tpoly.poly_open_scalars(c, x)
        assert torch.equal(y, wy) and torch.equal(q, wq), point


@pytest.mark.parametrize("alpha_kind", ["random", "zero"])
def test_commit_open_opens_every_row_in_one_call(monkeypatch, alpha_kind):
    """parallel.pianist.commit_open opens its Bl·Ml = 2·3 rows at α in one
    poly_open_scalars call (one launch of each opening kernel on the card),
    and its evals and the quotients it hands the MSMs are each row's own
    opening, limb for limb; the MSMs are stubbed."""
    from zkp_subnet_tpu_torch.ops import curve as tcv
    from zkp_subnet_tpu_torch.ops import msm as tmsm
    from zkp_subnet_tpu_torch.parallel import pianist as par
    bl, ml, t = 2, 3, 16
    rows = torch.stack([FR.encode(_row(t, 60 + k))
                        for k in range(bl * ml)]).view(bl, ml, t, FR.L)
    alpha = FR.encode([0 if alpha_kind == "zero" else _row(1, 70)[0]])[0]
    seen, calls = {}, []
    real = tpoly.poly_open_scalars

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    def msm_stub(bases, scalars):
        seen["scalars"] = scalars
        return tcv.g1_infinity(scalars.shape[:2])
    monkeypatch.setattr(tmsm, "msm_auto_groups", msm_stub)
    monkeypatch.setattr(tpoly, "poly_open_scalars", spy)
    _, evals, _ = par.commit_open(tcv.g1_infinity((ml, t)), rows, alpha)
    monkeypatch.undo()
    assert calls == [(bl * ml, t, FR.L)]
    canonical = tpoly.from_mont_wide(rows)
    for b in range(bl):
        for i in range(ml):
            y, q = tpoly.poly_open_scalars(rows[b, i], alpha)
            assert torch.equal(evals[b, i], y)
            assert torch.equal(seen["scalars"][i, bl + b], q)
            assert torch.equal(seen["scalars"][i, b], canonical[b, i])


def test_scan_plain_crosses_tiles():
    """fr_suffix_scan_plain's tiles and fr_open_quotient_plain's carry at a
    width that is no multiple of the tile (200 = 6 × 32 + 8), and a row of
    zeros: local sums and totals against Python's integers, the opening
    against the oracle and the CPU composition."""
    n, tile = 200, 32
    coeffs = _row(n, 9)
    c = FR.encode(coeffs)
    local, totals = tpoly.fr_suffix_scan_plain(c, tile)
    assert local.shape == (n, 8) and totals.shape == (7, 8)
    ends = [min(n, (j // tile + 1) * tile) for j in range(n)]
    assert FR.decode(local) == [sum(coeffs[j:e]) % o.R
                                for j, e in zip(range(n), ends)]
    assert FR.decode(totals) == [sum(coeffs[b:b + tile]) % o.R
                                 for b in range(0, n, tile)]
    for point in (_row(1, 10)[0], 0):
        x = FR.encode([point])[0]
        y, q = tpoly.open_pieces_plain(c, x, tile=tile)
        assert FR.decode(y) == [o.poly_eval(coeffs, point)]
        want = o.poly_quotient(coeffs, point) if point else coeffs[1:]
        assert FR.limbs_to_ints(q) == want + [0]
        wy, wq = tpoly.poly_open_scalars(c, x)
        assert torch.equal(y, wy) and torch.equal(q, wq)
    zeros = FR.zeros((n,))
    y, q = tpoly.open_pieces_plain(zeros, FR.encode([3])[0], tile=tile)
    assert not y.any() and not q.any()


def test_from_mont_wide_matches_jax():
    coeffs = _row(256, 7)
    jc = JFR.encode(coeffs)
    got = tpoly.from_mont_wide(FR.from_limbs16(np.asarray(jc)))
    want = jax.jit(jpoly.from_mont_wide)(jc)
    assert np.array_equal(FR.to_limbs16(got), np.asarray(want))
    assert FR.limbs_to_ints(got) == coeffs


@pytest.mark.parametrize("n", [tpoly.SCAN_TILE - 1, tpoly.SCAN_TILE,
                               tpoly.SCAN_TILE + 1, 2 * tpoly.SCAN_TILE + 3])
def test_scan_plain_at_the_kernels_tile(n):
    """fr_suffix_scan_plain at the kernel's tile (SCAN_TILE): a tile less
    one, one tile, one element past it, two tiles and a short third; one
    row and two at once: each tile's local suffix sums and its total
    against Python's integers."""
    tile = tpoly.SCAN_TILE
    rows = [_row(n, 70 + n), [0] * n]
    local, totals = tpoly.fr_suffix_scan_plain(
        FR.encode(sum(rows, [])).view(2, n, 8))
    for b, coeffs in enumerate(rows):
        ends = [min(n, (j // tile + 1) * tile) for j in range(n)]
        assert FR.decode(local[b]) == [sum(coeffs[j:e]) % o.R
                                       for j, e in zip(range(n), ends)]
        assert FR.decode(totals[b]) == [sum(coeffs[k:k + tile]) % o.R
                                        for k in range(0, n, tile)]
    one = tpoly.fr_suffix_scan_plain(FR.encode(rows[0]))
    assert torch.equal(one[0], local[0]) and torch.equal(one[1], totals[0])


# -- the row evaluation: K3 fr_eval_rows's plain version, poly_eval on a
# batch, poly_eval_many, and the rest of the JAX package's poly.py ---------

#: x = 0, 1, r − 1 and random
EVAL_POINTS = [0, 1, o.R - 1, _row(1, 40)[0]]


@pytest.fixture(scope="module")
def jax_eval_pairs():
    """The coordinator's evaluation (``jax.vmap`` of ``poly_eval``,
    zkp_subnet_tpu/runtime/coordinator.py:91), one row at its own point;
    jitted: one compile a row length instead of one an operation."""
    return jax.jit(jax.vmap(jpoly.poly_eval))


@pytest.mark.parametrize("n", [1, 16, 100])
def test_eval_rows_plain_and_batched_eval_match_jax(jax_eval_pairs, n):
    """fr_eval_rows_plain at tiles of 8 (one partial tile at 1, two at 16,
    thirteen at 100: the tiles joined by Horner runs of one step and the
    tree), at the kernel's tile, and the CPU poly_eval of a batch of rows
    at one x,
    against the JAX package's vmapped poly_eval, limb for limb, at x = 0,
    1, r − 1 and random; poly_eval_many (one row at the four points)
    against the same."""
    rows = [_row(n, 50 + 7 * n + i) for i in range(len(EVAL_POINTS))]
    jrows = JFR.encode(sum(rows, [])).reshape(len(rows), n, 16)
    jxs = JFR.encode(EVAL_POINTS)
    c = FR.from_limbs16(np.asarray(jrows))
    xs = FR.from_limbs16(np.asarray(jxs))

    got = tpoly.fr_eval_rows_plain(c, xs, tile=8)
    want = np.asarray(jax_eval_pairs(jrows, jxs))
    assert np.array_equal(FR.to_limbs16(got), want)
    assert FR.decode(got) == [o.poly_eval(r, x)
                              for r, x in zip(rows, EVAL_POINTS)]
    assert torch.equal(tpoly.fr_eval_rows_plain(c, xs), got)

    for i, point in enumerate(EVAL_POINTS):
        same_x = jnp.broadcast_to(jxs[i], jxs.shape)
        want = np.asarray(jax_eval_pairs(jrows, same_x))
        assert np.array_equal(FR.to_limbs16(tpoly.poly_eval(c, xs[i])),
                              want), point
        assert np.array_equal(FR.to_limbs16(tpoly.poly_eval(c[i], xs[i])),
                              want[i]), point
    same_row = jnp.broadcast_to(jrows[0], jrows.shape)
    want = np.asarray(jax_eval_pairs(same_row, jxs))
    assert np.array_equal(FR.to_limbs16(tpoly.poly_eval_many(c[0], xs)),
                          want)
    assert np.array_equal(FR.to_limbs16(tpoly.fr_eval_rows_plain(
        c[:1], xs, tile=8)), want)


@pytest.mark.parametrize("n, tile", [
    (1, None), (31, None), (32, None), (33, None), (tpoly.EVAL_TILE, None),
    (tpoly.EVAL_TILE + 1, None), (2 * tpoly.EVAL_TILE + 100, None),
    (34 * 32 + 5, 32)])
def test_eval_rows_plain_at_the_kernels_boundaries(n, tile):
    """fr_eval_rows_plain at the lengths where fr_eval_rows changes
    course: one coefficient, a lane's run of one or two steps (31, 32,
    33), one tile (EVAL_TILE), one past it, past two tiles; and, at tiles
    of 32, more than 32 tiles (the second pass's Horner steps over a lane's
    tiles). Four rows at x = 0, 1, r − 1 and random each, the four rows at
    each of those x, and one row at the four points (poly_eval_many),
    against the oracle."""
    tile = tile or tpoly.EVAL_TILE
    rows = [_row(n, 80 + n + i) for i in range(len(EVAL_POINTS))]
    rows[1] = [0] * n
    c = FR.encode(sum(rows, [])).view(len(rows), n, 8)
    xs = FR.encode(EVAL_POINTS)
    got = tpoly.fr_eval_rows_plain(c, xs, tile)
    assert FR.decode(got) == [o.poly_eval(r, x)
                              for r, x in zip(rows, EVAL_POINTS)]
    for i, point in enumerate(EVAL_POINTS):
        got = tpoly.fr_eval_rows_plain(c, xs[i:i + 1], tile)
        assert FR.decode(got) == [o.poly_eval(r, point) for r in rows]
    got = tpoly.fr_eval_rows_plain(c[3:4], xs, tile)
    assert FR.decode(got) == [o.poly_eval(rows[3], x) for x in EVAL_POINTS]
    if tile == tpoly.EVAL_TILE:
        assert torch.equal(tpoly.poly_eval_many(c[3], xs), got)


def test_eval_many_quotient_add_scale_match_jax():
    """poly_eval_many, poly_quotient, poly_add and poly_scale against the
    JAX package's functions (jitted) on a row of 4, at x = 0, 1, r − 1 and
    random; each against the oracle too."""
    n = 4
    row, other = _row(n, 60), _row(n, 61)
    jc, jd = JFR.encode(row), JFR.encode(other)
    jxs = JFR.encode(EVAL_POINTS)
    c, d = FR.from_limbs16(np.asarray(jc)), FR.from_limbs16(np.asarray(jd))
    xs = FR.from_limbs16(np.asarray(jxs))

    got = tpoly.poly_eval_many(c, xs)
    want = jax.jit(jpoly.poly_eval_many)(jc, jxs)
    assert np.array_equal(FR.to_limbs16(got), np.asarray(want))
    assert FR.decode(got) == [o.poly_eval(row, x) for x in EVAL_POINTS]

    quotient = jax.jit(jpoly.poly_quotient)
    for i, point in enumerate(EVAL_POINTS):
        got = tpoly.poly_quotient(c, xs[i])
        assert np.array_equal(FR.to_limbs16(got),
                              np.asarray(quotient(jc, jxs[i]))), point
        want = o.poly_quotient(row, point) if point else row[1:]
        assert FR.decode(got) == want, point

    got = tpoly.poly_add(c, d)
    assert np.array_equal(FR.to_limbs16(got),
                          np.asarray(jax.jit(jpoly.poly_add)(jc, jd)))
    assert FR.decode(got) == [(a + b) % o.R for a, b in zip(row, other)]
    scale = jax.jit(jpoly.poly_scale)
    for i, point in enumerate(EVAL_POINTS):
        got = tpoly.poly_scale(c, xs[i])
        assert np.array_equal(FR.to_limbs16(got),
                              np.asarray(scale(jc, jxs[i]))), point
        assert FR.decode(got) == [a * point % o.R for a in row]


@pytest.mark.parametrize("x_kind", ["random", "zero"])
def test_open_with_a_precomputed_inverse_is_the_same(x_kind):
    """poly_open_scalars and open_pieces_plain handed 1/x (as the callers
    that open many rows at one x do) give the opening without it, limb for
    limb, at a random x and at x = 0 (1/0 = 0)."""
    rng = np.random.default_rng(41)
    c = FR.encode([int(v) for v in rng.integers(0, 1 << 62, 20)])
    x = FR.encode([0 if x_kind == "zero" else
                   int.from_bytes(rng.bytes(40), "little") % o.R])[0]
    xi = FR.inv(x)
    for got, want in ((tpoly.poly_open_scalars(c, x, xi),
                       tpoly.poly_open_scalars(c, x)),
                      (tpoly.open_pieces_plain(c, x, 8, xi),
                       tpoly.open_pieces_plain(c, x, 8))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
