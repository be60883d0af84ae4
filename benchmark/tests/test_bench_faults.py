"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have; the harness's look for a card is
skipped (the CPU, the port's plain versions, toy sizes)."""

import json
import multiprocessing
import socket

import pytest

from benchmark.tests import helpers

SEED = 2 ** 32 + 21


@pytest.mark.parametrize("cell", ["toy_4_1.prove", "toy_4_1.batch2_xy"])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_fault_on_one_rank_is_not_correct(toy_root, monkeypatch, fault,
                                            cell):
    helpers.plant(fault, monkeypatch.setattr)
    line = helpers.run_cell(toy_root, cell, SEED)
    assert line["correct"] is False
    assert line["checks"]["aggregate"]["value"] > 0


@pytest.mark.parametrize("cell", ["toy_4_1.prove", "toy_4_1.batch2_xy",
                                  "toy_6_2.y"])
def test_a_sound_run_on_one_rank_is_correct(toy_root, cell):
    line = helpers.run_cell(toy_root, cell, SEED)
    assert line["correct"] is True, line["checks"]
    assert all(n > 0 for n in line["_seen"].values()), line["_seen"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(root, fault, cell="toy_4_1.prove2"):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    ports = [_free_port(), _free_port()]
    procs = [ctx.Process(target=helpers.rank_main,
                         args=(root, cell, SEED, r, 2, ports,
                               fault, queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = None
        while out is None:
            try:
                out = queue.get(timeout=5)
            except Exception:
                assert all(p.is_alive() or p.exitcode == 0 for p in procs), \
                    [p.exitcode for p in procs]
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
    assert all(p.exitcode == 0 for p in procs)
    return out


@pytest.mark.parametrize("cell,fault", [
    ("toy_4_1.prove2", None), ("toy_4_1.prove2", "no_exchange"),
    ("toy_4_1.prove2", "altered"), ("toy_4_1.y2", None),
    ("toy_4_1.y2", "no_exchange"), ("toy_4_1.batch_ranks2", None),
    ("toy_4_1.batch_ranks2", "altered")])
def test_two_ranks_over_gloo(toy_root, cell, fault):
    out = _world(toy_root, fault, cell)
    assert out["correct"] is (fault is None), out["_bad"]
    if fault is None:
        assert out["rc"] == 0
        assert json.loads(out["stdout"].splitlines()[-1])["correct"] is True


def test_a_forbidden_module_on_another_rank_prints_no_result(toy_root):
    from benchmark import run
    out = _world(toy_root, helpers.JAX_ON_RANK1)
    assert out["correct"] is True, out["_bad"]
    assert out["rc"] == run.FORBIDDEN_LOADED
    assert out["stdout"] == ""
