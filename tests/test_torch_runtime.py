"""The port's coordinator runtime (zkp_subnet_tpu_torch/runtime/: Coordinator,
LocalTransport, MockTransport, WorkerServer and HttpTransport, the Worker's
membership hooks) against the JAX package's runtime and the oracle.

Both packages hold the conftest's session SRS (scale 6, machines_scale 2:
four rows of 16): the port loads the files the JAX package saves of it,
on the CPU. Draws cannot
agree (``jax.random`` against ``torch.Generator``), so each package's
samplers are patched inside this module to hand out the same numpy-made
evaluation rows and α; the JAX package itself is not edited. The JAX
coordinator's challenge runs its own code with one difference: its
``jax.vmap`` of ``poly_eval`` is jitted (the same integers in one XLA
compile, where the eager vmap compiles every operation on its own, about
a minute on the CPU). ``reward`` reads the clock only through
``process_time``, which the tests fix, so both packages' floats are
identical.

The four rows are proved once: rows 0 and 1 by one real round through
``HttpTransport`` and a ``WorkerServer`` (a real port ``Worker`` behind
it), rows 2 and 3 by the port's ``Worker`` directly (a commit+open on the
CPU takes seconds: its MSMs run the plain PyTorch versions). The reward
matrix, the ``LocalTransport``/``MockTransport`` rounds, the run loop and
its resume reuse those responses through a stand-in worker. Tolerance:
none (b64 strings, integers, float32 scores compared exactly).
"""

import asyncio
import concurrent.futures
import dataclasses
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from conftest import TEST_MACHINES_SCALE, TEST_SCALE
from test_golden import _non_subgroup_g1
from zkp_subnet_tpu import runtime as jrt
from zkp_subnet_tpu.models import pianist as jpn
from zkp_subnet_tpu.models.srs import default_paths
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.runtime import coordinator as jcoord
from zkp_subnet_tpu.runtime.transport import _corrupt_b64 as j_corrupt_b64
from zkp_subnet_tpu.utils import encoding as enc
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.models import pianist as tpn
from zkp_subnet_tpu_torch.models.srs import Srs, _lagrange_coeffs_at
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops.field import FR
from zkp_subnet_tpu_torch.runtime.server import rpc
from zkp_subnet_tpu_torch.runtime.transport import _corrupt_b64

M = 1 << TEST_MACHINES_SCALE
T = 1 << (TEST_SCALE - TEST_MACHINES_SCALE)
TIMEOUT = 30.0
HOTKEYS = [f"hk{i}" for i in range(M)]
UNIFORM_FR, RANDOM_POINT = tpn._uniform_fr, tpn.random_point
AGGREGATE = tpn.aggregate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JitVmapJax(types.ModuleType):
    """``jax`` as the JAX coordinator module sees it, with ``vmap`` jitted."""

    def __init__(self):
        super().__init__("jax")
        self.vmap = lambda f: jax.jit(jax.vmap(f))

    def __getattr__(self, name):
        return getattr(jax, name)


class StandIn:
    """A worker that answers from proved responses: index i gets a copy of
    ``responses[i]`` with process_time 1 + i/4 s."""

    def __init__(self, responses, prove_cls):
        self.responses = responses
        self.prove_cls = prove_cls

    def forward(self, syn):
        r = self.responses[syn.index]
        return self.prove_cls(index=syn.index, poly=[], alpha=r.alpha,
                              eval_=r.eval_, commitment=r.commitment,
                              proof=r.proof, process_time=1.0 + syn.index / 4)


def _same_challenge(jax_coord, challenge):
    """The JAX coordinator's rounds get the challenge this module already
    held to the port's (its eager pieces would compile again)."""
    jax_coord.generate_challenge = lambda machines: challenge


@pytest.fixture(scope="module")
def world(srs, tmp_path_factory):
    """Both coordinators, the challenge from each, the server, and the four
    proved responses."""
    paths = default_paths(str(tmp_path_factory.mktemp("srs")), TEST_SCALE,
                          TEST_MACHINES_SCALE)
    srs.save(*paths)
    tsrs = Srs.load(*paths, device="cpu")
    rng = np.random.default_rng(0x5EED)
    evals = [int.from_bytes(rng.bytes(40), "little") % o.R
             for _ in range(M * T)]
    alpha = int.from_bytes(rng.bytes(40), "little") % o.R
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpn, "_uniform_fr", lambda gen, shape: FR.encode(
            evals, gen.device).reshape(*shape, FR.L))
        mp.setattr(tpn, "random_point",
                   lambda gen: FR.encode([alpha], gen.device)[0])
        mp.setattr(jpn, "_uniform_fr", lambda key, shape: JFR.encode(
            evals).reshape(*shape, JFR.L))
        mp.setattr(jpn, "random_point", lambda key: JFR.encode([alpha])[0])
        mp.setattr(jcoord, "jax", _JitVmapJax())

        cfg = dict(sample_size=M, timeout=TIMEOUT)
        jc = jrt.Coordinator(srs, jrt.CoordinatorConfig(**cfg), HOTKEYS,
                             seed=1)
        tc = trt.Coordinator(tsrs, trt.CoordinatorConfig(**cfg), HOTKEYS,
                             seed=1)
        jch, tch = jc.generate_challenge(M), tc.generate_challenge(M)

        worker = trt.Worker(tsrs, members=set(HOTKEYS))
        server = trt.WorkerServer(worker, port=0).start()
        try:
            http = trt.Coordinator(
                tsrs, trt.CoordinatorConfig(sample_size=2, timeout=600.0),
                HOTKEYS, seed=3)
            transport = trt.HttpTransport({u: server.url for u in range(M)})
            http_round = http.run_round(transport)
            responses = list(http_round[1]) + [
                worker.forward(tch.to_synapse(i)) for i in (2, 3)]
            yield types.SimpleNamespace(
                tsrs=tsrs, jsrs=srs, evals=evals, alpha=alpha, jc=jc, tc=tc,
                jch=jch, tch=tch, server=server, worker=worker, http=http,
                http_round=http_round, responses=responses)
        finally:
            server.stop()


def _both(prove, pkg):
    """The same message as the other package's ``Prove``."""
    return pkg.Prove(**dataclasses.asdict(prove))


def _coords(w, **cfg):
    return (jrt.Coordinator(w.jsrs, jrt.CoordinatorConfig(**cfg), HOTKEYS,
                            seed=5),
            trt.Coordinator(w.tsrs, trt.CoordinatorConfig(**cfg), HOTKEYS,
                            seed=5))


# -- the challenge -------------------------------------------------------------

def test_challenge_matches_jax_and_the_oracle(world):
    """Every field of the port's Challenge equals the JAX coordinator's as
    b64 strings; rows are the inverse NTT of the evaluations and the evals
    are the rows at α (oracle)."""
    jch, tch = world.jch, world.tch
    assert tch.polys == jch.polys
    assert tch.alpha == jch.alpha == enc.fr_to_b64(world.alpha)
    assert tch.evals == jch.evals
    row0 = o.intt(world.evals[:T])
    assert enc.poly_from_b64(tch.polys[0]) == row0
    assert [enc.fr_from_b64(e) for e in tch.evals] == [
        o.poly_eval(enc.poly_from_b64(p), world.alpha) for p in tch.polys]
    assert tch.to_synapse(2) == _both(jch.to_synapse(2), trt)
    assert world.tc.generator.device.type == "cpu"


# -- the reward matrix (reference: tests/test_validator.py:60-121) ------------

REWARD_CASES = ["complete", "half time", "missing commitment", "too late",
                "corrupted", "another worker's row", "index below range",
                "index above range", "non-subgroup point",
                "replayed index"]


def _reward_case(name, responses):
    """(response, expected_index, does it score) for one case."""
    r = responses[0]
    fields = dict(index=r.index, poly=[], alpha=r.alpha, eval_=r.eval_,
                  commitment=r.commitment, proof=r.proof, process_time=3.0)
    expected = None
    if name == "half time":
        fields["process_time"] = TIMEOUT / 2
    elif name == "missing commitment":
        fields["commitment"] = None
    elif name == "too late":
        fields["process_time"] = TIMEOUT + 1.0
    elif name == "corrupted":
        fields["proof"] = _corrupt_b64(r.proof)
        assert fields["proof"] == j_corrupt_b64(r.proof)
    elif name == "another worker's row":
        fields["index"] = 1
    elif name == "index below range":
        fields["index"] = -1
    elif name == "index above range":
        fields["index"] = M
    elif name == "non-subgroup point":
        fields["commitment"] = enc.g1_to_b64(_non_subgroup_g1())
    elif name == "replayed index":
        r = responses[1]
        fields.update(index=1, eval_=r.eval_, commitment=r.commitment,
                      proof=r.proof)
        expected = 0
    scores = name in ("complete", "half time")
    return trt.Prove(**fields), expected, scores


@pytest.mark.parametrize("case", REWARD_CASES)
def test_reward_matrix_matches_jax(world, case):
    resp, expected, scores = _reward_case(case, world.responses)
    got = world.tc.reward(world.tch, resp, expected_index=expected)
    want = world.jc.reward(world.jch, _both(resp, jrt),
                           expected_index=expected)
    assert got == want
    assert (got > 0) == scores
    if case == "complete":
        assert got == 1.0 - 3.0 / TIMEOUT
    if case == "replayed index":       # the same response, dispatched as 1
        assert world.tc.reward(world.tch, resp, expected_index=1) > 0


# -- rounds --------------------------------------------------------------------

def test_http_round_proves_and_scores(world):
    """The real round: two rows proved by the WorkerServer's Worker over
    HTTP, each reward > 0, the same rewards from the JAX coordinator, and
    the proofs equal to the port Worker's own and to the oracle's eval."""
    challenge, responses, rewards = world.http_round
    assert challenge == world.tch
    assert [r.index for r in responses] == [0, 1]
    assert all(r.commitment and r.proof for r in responses)
    assert all(r > 0 for r in rewards) and rewards.dtype == np.float32
    assert np.array_equal(rewards, world.jc.get_rewards(
        world.jch, [_both(r, jrt) for r in responses], 600.0, [0, 1]))
    assert world.http.step == 1 and world.http.scores.max() > 0
    for r in responses:
        assert r.eval_ == world.tch.evals[r.index]
    bad = trt.HttpTransport({0: "http://127.0.0.1:9"})
    late = asyncio.run(bad.query([0, 1], [challenge.to_synapse(0),
                                          challenge.to_synapse(1)], 5.0))
    assert [(r.status_code, r.process_time, r.proof) for r in late] == \
        [(408, 5.0, None)] * 2


def test_local_transport_round_matches_jax(world):
    jc, tc = _coords(world, sample_size=M, timeout=TIMEOUT)
    _same_challenge(jc, world.jch)
    tout = tc.run_round(trt.LocalTransport(
        {u: StandIn(world.responses, trt.Prove) for u in range(M)}))
    jout = jc.run_round(jrt.LocalTransport(
        {u: StandIn(world.responses, jrt.Prove) for u in range(M)}))
    assert tout[0] == world.tch
    assert [dataclasses.asdict(r) for r in tout[1]] == \
        [dataclasses.asdict(r) for r in jout[1]]
    assert np.array_equal(tout[2], jout[2]) and (tout[2] > 0).all()
    assert np.array_equal(tc.scores, jc.scores)
    # an unknown uid answers 404, and an empty round raises
    lost = trt.LocalTransport({})
    resp = asyncio.run(lost.query([0], [world.tch.to_synapse(0)], 1.0))[0]
    assert resp.status_code == 404 and resp.commitment is None
    with pytest.raises(RuntimeError, match="all workers failed"):
        tc.run_round(lost)


def test_mock_transport_round_matches_jax(world):
    """Fabricated latencies in [1, 2) s with uid 2's proof corrupted: that
    uid scores exactly 0, the others > 0; a late transport answers 408."""
    jc, tc = _coords(world, sample_size=M, timeout=TIMEOUT)
    _same_challenge(jc, world.jch)
    kw = dict(min_time=1.0, max_time=2.0, seed=9, corrupt_uids=[2])
    tout = tc.run_round(trt.MockTransport(
        {u: StandIn(world.responses, trt.Prove) for u in range(M)}, **kw))
    jout = jc.run_round(jrt.MockTransport(
        {u: StandIn(world.responses, jrt.Prove) for u in range(M)}, **kw))
    assert np.array_equal(tout[2], jout[2])
    assert np.array_equal(tc.scores, jc.scores)
    corrupt = [i for i, r in enumerate(tout[1])
               if r.proof != world.responses[r.index].proof]
    assert len(corrupt) == 1 and tout[2][corrupt[0]] == 0.0
    assert all(v > 0 for i, v in enumerate(tout[2]) if i != corrupt[0])
    assert tc.scores[2] == 0.0
    late = trt.MockTransport({1: StandIn(world.responses, trt.Prove)},
                             min_time=50.0, max_time=60.0)
    resp = asyncio.run(late.query([1], [world.tch.to_synapse(1)], TIMEOUT))
    assert resp[0].status_code == 408
    assert tc.reward(world.tch, resp[0]) == 0.0


def test_run_loop_and_resume_match_jax(world, tmp_path):
    """The continuous loop (two concurrent forwards an iteration, weights
    every second step, state each sync) and a resume from state.npz, in
    both packages: the same steps, scores, weights and files; each package
    resumes from the other's state file."""
    def loop(pkg, state_dir, seed, rounds, resume=False):
        cfg = pkg.CoordinatorConfig(sample_size=M, timeout=TIMEOUT,
                                    epoch_length=2,
                                    num_concurrent_forwards=2,
                                    state_dir=str(state_dir))
        srs = world.tsrs if pkg is trt else world.jsrs
        coord = pkg.Coordinator(srs, cfg, HOTKEYS, seed=seed)
        if pkg is jrt:
            _same_challenge(coord, world.jch)
        if resume:
            assert coord.load_state()
        ok = asyncio.run(coord.run(pkg.LocalTransport(
            {u: StandIn(world.responses, pkg.Prove) for u in range(M)}),
            rounds=rounds))
        return coord, ok

    (a, ok_a), (b, ok_b) = (loop(pkg, tmp_path / pkg.__name__, 8, 4)
                            for pkg in (trt, jrt))
    assert ok_a == ok_b >= 4
    assert (a.step, a.last_weights_step) == (b.step, b.last_weights_step)
    assert np.array_equal(a.scores, b.scores) and a.scores.max() > 0
    assert all(np.array_equal(x, y)
               for x, y in zip(a.last_weights, b.last_weights))
    step = a.step
    # each resumes from the other's file
    for pkg, other in ((trt, jrt), (jrt, trt)):
        src = tmp_path / other.__name__ / "state.npz"
        dst = tmp_path / ("resume-" + pkg.__name__)
        dst.mkdir()
        (dst / "state.npz").write_bytes(src.read_bytes())
    resumed = [loop(pkg, tmp_path / ("resume-" + pkg.__name__), 11, 2,
                    resume=True) for pkg in (trt, jrt)]
    (a, ok_a), (b, ok_b) = resumed
    assert ok_a == ok_b and a.step == b.step == step + 2
    assert a.last_weights_step == b.last_weights_step
    assert np.array_equal(a.scores, b.scores)


# -- scores, weights, membership -----------------------------------------------

def _parity(jc, tc, fields=("scores", "serving", "validator_permit",
                            "stake", "hotkeys", "step")):
    for name in fields:
        a, b = getattr(tc, name), getattr(jc, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


def test_update_scores_and_set_weights_match_jax(world):
    jc, tc = _coords(world)
    assert [c.set_weights()[0].size for c in (jc, tc)] == [0, 0]
    for rewards, uids in (([1.0, 0.5], [0, 2]), ([1.0], [0]),
                          ([0.25, np.nan, 0.75], [3, 1, 2])):
        for c in (jc, tc):
            c.update_scores(np.array(rewards), uids)
        _parity(jc, tc)
    (tu, tw), (ju, jw) = tc.set_weights(), jc.set_weights()
    assert np.array_equal(tu, ju) and tu.dtype == ju.dtype
    assert np.array_equal(tw, jw) and tw.dtype == jw.dtype == np.uint16
    assert tw.max() == 65535
    for c in (jc, tc):
        c.scores = np.zeros(M, dtype=np.float32)
    (tu, tw), (ju, jw) = tc.set_weights(), jc.set_weights()
    assert tu.size == ju.size == tw.size == jw.size == 0


@pytest.mark.parametrize("new", [["hk0", "X", "hk2", "hk3", "new"],
                                 ["hk0", "Y"]], ids=["grow", "shrink"])
def test_resync_matches_jax(world, new):
    jc, tc = _coords(world)
    for c in (jc, tc):
        c.scores = np.array([0.4, 0.3, 0.2, 0.1], dtype=np.float32)
        c.serving[3] = False
        c.stake[2] = 5.0
        c.resync(new)
    _parity(jc, tc)
    assert tc.scores[1] == 0.0 and len(tc.scores) == len(new)
    assert [c.set_weights()[0].tolist() for c in (jc, tc)] == \
        [tc.set_weights()[0].tolist()] * 2


def test_should_set_weights_matches_jax(world):
    jc, tc = _coords(world, epoch_length=3)
    seen = []
    for step, last, disabled in ((0, 0, False), (2, 0, False), (3, 0, False),
                                 (5, 3, False), (6, 3, False),
                                 (6, 3, True)):
        got = []
        for c in (jc, tc):
            c.step, c.last_weights_step = step, last
            c.config.disable_set_weights = disabled
            got.append(c.should_set_weights())
        assert got[0] == got[1]
        seen.append(got[1])
    assert seen == [False, False, True, False, True, False]


def test_get_random_uids_with_availability_matches_jax(world):
    """Availability (not serving, high-stake validator out, low-stake in),
    exclusion with top-up, and ``available``: the same uids from the same
    seed."""
    hotkeys = [f"hk{i}" for i in range(8)]
    coords = [pkg.Coordinator(srs, pkg.CoordinatorConfig(
        vpermit_tao_limit=100.0), hotkeys, seed=4)
        for pkg, srs in ((jrt, world.jsrs), (trt, world.tsrs))]
    for c in coords:
        c.serving[5] = False
        c.validator_permit[6:8] = True
        c.stake[6], c.stake[7] = 1000.0, 50.0
    draws = [[c.check_uid_availability(u) for u in range(8)]
             + [c.get_random_uids(6) for _ in range(5)]
             + [c.get_random_uids(3, exclude=[0, 1, 2]),
                c.get_random_uids(6, exclude=[0]),
                c.get_random_uids(2, available=[1, 3, 5])]
             for c in coords]
    assert draws[0] == draws[1]
    assert draws[1][:8] == [True] * 5 + [False, False, True]
    assert all(5 not in d and 6 not in d for d in draws[1][8:13])


def test_state_npz_loads_across_packages(world, tmp_path):
    """state.npz written by either package loads in the other, also into a
    coordinator built with fewer hotkeys (the availability arrays follow
    the restored membership); a missing file loads nothing."""
    for writer, reader in ((trt, jrt), (jrt, trt)):
        d = str(tmp_path / writer.__name__)
        srs_w = world.tsrs if writer is trt else world.jsrs
        srs_r = world.tsrs if reader is trt else world.jsrs
        c = writer.Coordinator(srs_w, writer.CoordinatorConfig(state_dir=d),
                               list("abcdef"))
        c.scores = np.linspace(0.6, 0.1, 6).astype(np.float32)
        c.step, c.last_weights_step = 7, 5
        path = c.save_state()
        fresh = [pkg.Coordinator(srs, pkg.CoordinatorConfig(state_dir=d),
                                 list("ab"))
                 for pkg, srs in ((reader, srs_r), (writer, srs_w))]
        assert all(f.load_state() for f in fresh)
        _parity(*fresh, fields=("scores", "serving", "validator_permit",
                                "stake", "hotkeys", "step",
                                "last_weights_step"))
        assert fresh[0].hotkeys == list("abcdef") and fresh[0].step == 7
        assert np.array_equal(fresh[0].scores, c.scores)
        assert np.load(path, allow_pickle=True)["hotkeys"].dtype == object
    empty = trt.Coordinator(world.tsrs, trt.CoordinatorConfig(
        state_dir=str(tmp_path / "none")), HOTKEYS)
    assert not empty.load_state()


def test_blacklist_and_priority_match_jax(world):
    for members, cfg, permits in (
            ({"good"}, {}, None), ({"good"}, {}, {"other"}),
            ({"good"}, {"allow_non_registered": True}, None),
            ({"good"}, {"force_validator_permit": False}, {"other"}),
            (None, {}, None)):
        workers = [pkg.Worker(srs, pkg.WorkerConfig(**cfg), members=members)
                   for pkg, srs in ((jrt, world.jsrs), (trt, world.tsrs))]
        for caller in ("good", "stranger"):
            got = [w.blacklist(caller, permits) for w in workers]
            assert got[0] == got[1], (members, cfg, permits, caller)
        assert [w.priority("good", stake=lambda _: 12.5) for w in workers] \
            == [12.5, 12.5]
        assert [w.priority("good") for w in workers] == [0.0, 0.0]
    assert trt.Worker(world.tsrs, members={"good"}).blacklist("good") == \
        (False, "ok")


# -- aggregation ---------------------------------------------------------------

def test_aggregate_responses_verifies(world, monkeypatch):
    """The complete response set folds into one bivariate opening at a
    fresh β: pianist.aggregate called at that β on the responses' points
    and the challenge's evals, every field equal to the oracle's (C = Σ C_i,
    W = Σ W_i, C_y = Σ y_i·V_i, W_y = Σ q_i·V_i, the value f(α, β)),
    verify_aggregated True, and False at another β; an incomplete set is
    refused."""
    monkeypatch.setattr(tpn, "_uniform_fr", UNIFORM_FR)
    monkeypatch.setattr(tpn, "random_point", RANDOM_POINT)
    calls = []

    def spy(*args):
        calls.append(args)
        return AGGREGATE(*args)

    monkeypatch.setattr(tpn, "aggregate", spy)
    tc = world.tc
    agg, alpha, beta = tc.aggregate_responses(world.tch, world.responses)
    assert alpha == world.alpha and beta != alpha
    assert tc.verify_aggregated(agg, alpha, beta)
    assert not tc.verify_aggregated(agg, alpha, (beta + 1) % o.R)

    ys = [enc.fr_from_b64(e) for e in world.tch.evals]
    coms = [enc.g1_from_b64(r.commitment) for r in world.responses]
    prfs = [enc.g1_from_b64(r.proof) for r in world.responses]
    (srs, c_t, p_t, y_t, b_t), = calls
    assert srs is world.tsrs and FR.decode(b_t) == [beta]
    assert FR.decode(y_t) == ys and torch.equal(agg.evals, y_t)
    assert [tcv.g1_affine(t) for t in (c_t, p_t)] == \
        [[o.G1.to_affine(q) for q in pts] for pts in (coms, prfs)]

    lag = _lagrange_coeffs_at(beta, M)
    value = sum(a * y for a, y in zip(lag, ys)) % o.R
    w = o.fr_root_of_unity(TEST_MACHINES_SCALE)
    keys = tcv.g1_decode(world.tsrs.lagrange_y)
    q = [(y - value) * pow((pow(w, i, o.R) - beta) % o.R, o.R - 2, o.R)
         % o.R for i, y in enumerate(ys)]

    def total(pts, ks=None):
        acc = o.G1.infinity()
        for i, p in enumerate(pts):
            acc = o.G1.add(acc, p if ks is None else o.G1.mul(p, ks[i]))
        return o.G1.to_affine(acc)

    assert FR.decode(agg.value) == [value]
    for name, want in (("commitment", total(coms)), ("proof_x", total(prfs)),
                       ("commitment_y", total(keys, ys)),
                       ("proof_y", total(keys, q))):
        assert tcv.g1_affine(getattr(agg, name))[0] == want, name
    with pytest.raises(ValueError, match="all worker responses"):
        tc.aggregate_responses(world.tch, world.responses[:3])


# -- the server's methods over rpc ---------------------------------------------

def test_worker_server_methods_over_rpc(world, monkeypatch):
    """Every method of WorkerServer._dispatch through ``rpc``: against the
    port's Worker (the round's proofs), the oracle (NTT, evaluation) and a
    generator of the server's seed; unknown methods and rows answer 400."""
    monkeypatch.setattr(tpn, "_uniform_fr", UNIFORM_FR)
    monkeypatch.setattr(tpn, "random_point", RANDOM_POINT)
    url, ch, r0 = world.server.url, world.tch, world.responses[0]
    poly = ch.polys[0]
    # an MSM on the CPU takes seconds, more on a loaded machine
    assert rpc(url, "worker_commit", {"index": 0, "poly": poly},
               timeout=600.0) == {"commitment": r0.commitment}
    assert rpc(url, "worker_open", {"index": 0, "poly": poly,
                                    "x": ch.alpha}, timeout=600.0) == \
        {"eval": r0.eval_, "proof": r0.proof}
    verify = {"index": 0, "proof": r0.proof, "alpha": ch.alpha,
              "eval": r0.eval_, "commitment": r0.commitment}
    assert rpc(url, "worker_verify", verify) == {"valid": True}
    assert rpc(url, "worker_verify", {**verify, "index": 1}) == \
        {"valid": False}
    ping = rpc(url, "prove", {"index": 3, "poly": []})
    assert ping["index"] == 3 and ping["commitment"] is None

    row = enc.poly_from_b64(poly)
    out = rpc(url, "fft", {"poly": poly})["poly"]
    assert enc.poly_from_b64(out) == o.ntt(row)
    out = rpc(url, "fft", {"poly": ch.polys, "inverse": True})["poly"]
    assert [enc.poly_from_b64(p) for p in out] == \
        [o.intt(enc.poly_from_b64(p)) for p in ch.polys]
    cols = rpc(url, "fft", {"poly": ch.polys, "left": False})["poly"]
    mat = [enc.poly_from_b64(p) for p in ch.polys]
    col0 = o.ntt([mat[i][0] for i in range(M)])
    assert [enc.fr_from_b64(cols[i][0]) for i in range(M)] == col0
    y = rpc(url, "eval", {"poly": poly, "x": ch.alpha})["y"]
    assert y == ch.evals[0] == enc.fr_to_b64(o.poly_eval(row, world.alpha))

    gen = torch.Generator().manual_seed(0)
    want_rows = FR.to_limbs16(FR.from_mont(tpn.random_poly(world.tsrs, gen)))
    want_point = FR.decode(tpn.random_point(gen))[0]
    got = rpc(url, "random_poly", {})["poly"]
    assert got == [enc.limbs_to_b64(r) for r in want_rows]
    assert len(got) == M and all(len(r) == T for r in got)
    assert rpc(url, "random_point", {}) == {"point": enc.fr_to_b64(want_point)}

    for method, payload in (("nope", {}), ("worker_commit",
                                           {"index": M, "poly": poly})):
        with pytest.raises(Exception, match="400"):
            rpc(url, method, payload)
    with pytest.raises(Exception, match="500"):
        rpc(url, "eval", {"poly": poly})


# -- the kernel loader under the runtime's threads --------------------------

def test_kernel_loader_and_counts_are_safe_under_threads(monkeypatch):
    """Workers run in executor and server threads: 16 threads at once load
    the library once (one build, one bind) and lose no launch count, with
    the interpreter switching threads as often as it can."""
    from zkp_subnet_tpu_torch.ops import kernels

    builds, binds = [], []
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_build", lambda force: builds.append(1))
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(kernels, "_bind", lambda lib: binds.append(1) or lib)
    monkeypatch.setattr(kernels.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    before = kernels.LAUNCHES["fr_add"]
    per_thread, threads = 2000, 16
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=60)
        lib = kernels._load()
        for _ in range(per_thread):
            kernels._launch("fr_add", lambda *args: 0)
        return lib

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            libs = [f.result(timeout=120)
                    for f in [pool.submit(work) for _ in range(threads)]]
    finally:
        sys.setswitchinterval(interval)
    assert len(builds) == len(binds) == 1 and len({id(x) for x in libs}) == 1
    assert kernels.LAUNCHES["fr_add"] - before == per_thread * threads
    kernels.LAUNCHES["fr_add"] = before
