"""The control, the reference with every element cut to 254 bits put in
the program's place, comes out as not correct at a test's size."""

import pytest

from benchmark import control, judge
from benchmark.tests import helpers


@pytest.mark.parametrize("cell", ["toy_6_2.prove", "toy_4_1.batch2_xy"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(toy_root, seed, cell):
    bad = control.readings(helpers.spec_of(toy_root), cell, seed, "cpu")
    assert not judge.correct(bad)
    assert bad["commitments"] > 0 and bad["aggregate"] > 0
