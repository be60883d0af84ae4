"""The plain reference agrees with the port at scale 6/2 on the CPU: the
harness's whole run is correct, and each definition the reference holds the
port to is checked against the port's own answer."""

import random

import pytest
import torch

from benchmark import reference as ref
from benchmark.tests import helpers
from benchmark.traffic import Traffic


def test_a_run_at_6_2_is_correct_in_every_check(toy_root):
    line = helpers.run_cell(toy_root, "toy_6_2.prove", 2 ** 33 + 11)
    seen = line["_seen"]
    assert line["correct"], line["checks"]
    assert all(v["value"] == 0 for v in line["checks"].values())
    # round 0 is the only round and the one sampled (pool 2, 1 sampled)
    # on this seed, so every check compared something
    assert all(seen[name] > 0 for name in seen), seen
    assert line["attempted"] == 1 and line["failed"] == 0


def test_inverse_ntt_and_opening_match_the_port():
    from zkp_subnet_tpu_torch.ops import ntt, poly
    from zkp_subnet_tpu_torch.ops.field import FR
    tr = Traffic({"pool": 1}, {"scale": 6, "machines_scale": 2}, 5)
    rows = tr.rows(0, 0, 4, "cpu")                        # (4, 16, 8)
    coeffs = ntt.ntt_batch(rows, inverse=True)
    x = random.Random(1).randrange(ref.R)
    want = [v[0] for v in ref.row_values(
        rows, ref.weight_limbs([ref.lagrange_at(x, 16)], "cpu"))]
    got = [sum(c * pow(x, j, ref.R) for j, c in enumerate(
        ref.fr_values(row.numpy()))) % ref.R for row in coeffs]
    assert got == want
    xw = torch.from_numpy(ref.fr_words([x])[0])
    ys, _ = poly.poly_open_scalars(coeffs, xw, FR.inv(xw))
    assert ref.fr_values(ys.numpy()) == want


@pytest.mark.parametrize("transforms", [("y",), ("x", "y"), ()])
def test_the_reference_follows_the_traffics_transforms(transforms):
    from zkp_subnet_tpu_torch.ops import ntt
    tr = Traffic({"pool": 1}, {"scale": 6, "machines_scale": 2}, 7)
    rows = tr.rows(0, 0, 4, "cpu")                        # (4, 16, 8)
    coeffs = rows
    for axis in transforms:
        if axis == "x":
            coeffs = ntt.ntt_batch(coeffs, inverse=True)
        else:
            coeffs = ntt.ntt_batch(coeffs.transpose(0, 1).contiguous(),
                                   inverse=True).transpose(0, 1)
    z = random.Random(3).randrange(ref.R)
    reference = ref.Reference(5, 6, 4, 16, z, "cpu", transforms)
    got = [sum(c * pow(z, j, ref.R) for j, c in enumerate(
        ref.fr_values(row.numpy()))) % ref.R for row in coeffs]
    assert reference.challenge(rows, 8, 9).at_z == got
    other = ref.Reference(5, 6, 4, 16, z, "cpu", ("x",) if transforms != (
        "x",) else ("y",))
    assert other.challenge(rows, 8, 9).at_z != got


def test_srs_points_match_the_port():
    from zkp_subnet_tpu_torch.models.srs import Srs
    tau_x, tau_y = 12345, 67890
    srs = Srs.generate(6, 2, tau_x=tau_x, tau_y=tau_y, device="cpu")
    reference = ref.Reference(tau_x, tau_y, 4, 16, 0, "cpu")
    comb = reference.comb
    for j in (0, 1, 15):
        assert ref.point_matches(srs.g1_x[j].numpy(), comb.mul(
            reference.srs_scalar("g1_x", (j,))))
    for i, j in ((0, 0), (3, 7), (2, 15)):
        assert ref.point_matches(srs.worker_bases[i, j].numpy(), comb.mul(
            reference.srs_scalar("bases", (i, j))))
    for i in range(4):
        assert ref.point_matches(srs.lagrange_y[i].numpy(), comb.mul(
            reference.srs_scalar("lagrange_y", (i,))))
    assert not ref.point_matches(srs.lagrange_y[0].numpy(), comb.mul(
        reference.srs_scalar("lagrange_y", (1,))))


def test_points_compare_projectively():
    comb = ref.Comb()
    p = comb.mul(99)
    words = ref.point_words(p)
    assert ref.point_matches(words, p)
    assert not ref.point_matches(words, comb.mul(100))
    assert ref.point_matches(ref.point_words(ref.INF), ref.INF)
    assert not ref.point_matches(ref.point_words(ref.INF), p)


def test_dot_products_are_exact_past_a_chunk():
    n = ref.DOT_CHUNK + 3
    gen = torch.Generator().manual_seed(0)
    words = torch.randint(-2 ** 31, 2 ** 31, (2, n, 8), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    weights = [random.Random(2).randrange(1 << 256) for _ in range(n)]
    got = ref.combine(ref.dot_sums(words, ref.weight_limbs([weights],
                                                           "cpu")))
    want = [sum(a * b for a, b in zip(ref.words_to_ints(row.numpy()),
                                      weights)) for row in words]
    assert got == want
