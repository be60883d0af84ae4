"""The prove's profiler ranges (``zkp_subnet_tpu_torch/utils/trace.py``):
recorded, nested and in order while torch.profiler records, absent and
free of any ``record_function`` while it does not, and without effect on
the outputs. A one-rank gloo mesh on the CPU at scale 4 / machines_scale 1
(M = 2 workers, rows of T = 8)."""

import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._C._profiler import RecordScope, _ExperimentalConfig
from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                            _disable_profiler, _enable_profiler,
                            _prepare_profiler)

from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops.field import FR
from zkp_subnet_tpu_torch.parallel import pianist as par
from zkp_subnet_tpu_torch.utils import trace

torch.set_num_threads(1)

ORDER = ["fft", "prove", "commit_open", "open", "msm", "gather",
         "aggregate"]


@pytest.fixture(scope="module")
def mesh_srs():
    started = not dist.is_initialized()
    mesh = par.make_mesh(device="cpu")
    srs = par.shard_srs(Srs.generate(4, 1, seed=3, device="cpu"), mesh)
    yield mesh, srs
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _inputs(srs):
    rng = np.random.default_rng(5)
    m, t = srs.machines, srs.row_size
    rows = FR.encode([int(x) for x in rng.integers(0, 2 ** 62, m * t)],
                     "cpu").view(1, m, t, FR.L)
    alpha = FR.encode([int(rng.integers(2, 2 ** 62))], "cpu")[0]
    beta = FR.encode([int(rng.integers(2, 2 ** 62))], "cpu")
    return rows, alpha, beta


def _round(mesh, srs):
    rows, alpha, beta = _inputs(srs)
    coeffs = par.fft(rows, mesh, inverse=True)
    return coeffs, par.prove(srs, coeffs, alpha, beta, mesh)


@contextlib.contextmanager
def _user_ranges():
    """A torch.profiler session on the CPU that records the user's
    ``record_function`` ranges alone: the plain CPU kernels run some
    hundred thousand small ops a round, which a session recording every op
    takes minutes to record and read back. Yields the list it fills, on
    leaving, with the zkp.* ranges as (start, end, name) in order of
    start."""
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    spans = []
    try:
        yield spans
    finally:
        result = _disable_profiler()
    spans.extend(sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns(),
         e.name()[len(trace.PREFIX):]) for e in result.events()
        if e.name().startswith(trace.PREFIX)))


def _profiled(fn):
    with _user_ranges() as spans:
        out = fn()
    return out, spans


def test_without_a_profiler_span_is_the_shared_null_context(monkeypatch,
                                                            mesh_srs):
    assert not torch.autograd._profiler_enabled()
    assert trace.span("prove") is trace.span("fft") is trace._OFF
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    _round(*mesh_srs)
    assert made == []


def test_a_profiled_round_nests_its_spans_in_order(mesh_srs):
    _, spans = _profiled(lambda: _round(*mesh_srs))
    assert [name for _, _, name in spans] == ORDER
    at = {name: (s, e) for s, e, name in spans}

    def inside(child, parent):
        return at[parent][0] <= at[child][0] <= at[child][1] <= at[parent][1]
    for child in ("commit_open", "gather", "aggregate"):
        assert inside(child, "prove")
    for child in ("open", "msm"):
        assert inside(child, "commit_open")
    assert at["fft"][1] <= at["prove"][0]
    assert at["open"][1] <= at["msm"][0]
    assert at["commit_open"][1] <= at["gather"][0]
    assert at["gather"][1] <= at["aggregate"][0]


def test_msm_many_records_its_digit_sort(mesh_srs):
    points = mesh_srs[1].worker_bases[0]
    scalars = tcv.fr_to_scalar_limbs(
        [3 ** k + 5 for k in range(points.shape[0])])[None]
    out, spans = _profiled(lambda: tmsm.msm_many(points, scalars))
    assert [name for _, _, name in spans] == ["bucket_runs"]
    assert torch.equal(out, tmsm.msm_many(points, scalars))


def test_outputs_are_the_same_with_and_without_the_profiler(mesh_srs):
    plain = _round(*mesh_srs)
    traced, _ = _profiled(lambda: _round(*mesh_srs))
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)
