"""The benchmark's CPU tests: the port's plain versions, one torch thread,
the repository's root importable."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    from benchmark.tests import helpers
    return helpers.make_root(str(tmp_path_factory.mktemp("bench")))
