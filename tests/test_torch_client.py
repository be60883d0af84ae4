"""The port's client API (zkp_subnet_tpu_torch/api/client.py: ``ping_uids``,
``get_query_uids``, ``SubnetClient``) against the JAX package's, on the same
stand-in coordinator and transport, and one real commit / open / verify of
a toy row through the port's ``Worker`` on the CPU, against the oracle.

The stand-ins answer from fixed tables, so nothing here compiles a JAX
function. The outputs agree but in four places, each a fault of the
original (``zkp_subnet_tpu/api/client.py:31``, ``:58``, ``:62``, ``:82``);
each has a test below that shows both sides.
"""

import asyncio
import random
import types

import numpy as np
import pytest
import torch

from zkp_subnet_tpu import api as japi
from zkp_subnet_tpu.api import client as jclient
from zkp_subnet_tpu.runtime.protocol import Prove as JProve
from zkp_subnet_tpu_torch import api as tapi
from zkp_subnet_tpu_torch.api import client as tclient
from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.runtime.protocol import Prove as TProve
from zkp_subnet_tpu_torch.utils import encoding as enc
from zkp_subnet_tpu_torch.utils import oracle as o

PACKAGES = {"jax": (jclient, JProve), "torch": (tclient, TProve)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Coord:
    """What the clients read of a coordinator: hotkeys, EMA scores,
    availability, the seeded uid stream, the timeout and the verify."""

    def __init__(self, scores, seed=0, unavailable=()):
        self.hotkeys = [f"hk{i}" for i in range(len(scores))]
        self.scores = np.asarray(scores, dtype=np.float32)
        self.rng = random.Random(seed)
        self.unavailable = set(unavailable)
        self.config = types.SimpleNamespace(timeout=7.0)
        self.verified = []

    def check_uid_availability(self, uid):
        return uid not in self.unavailable

    def get_random_uids(self, k):
        return self.rng.sample(range(len(self.hotkeys)), k)

    def verify_worker(self, i, proof, x, y, commitment):
        self.verified.append((i, proof, x, y, commitment))
        return proof == "good-proof"


class Net:
    """A transport answering from a table: a uid in ``down`` times out
    (408), any other is served; every query is recorded."""

    def __init__(self, prove_cls, down=(), commitment="C", proof="P",
                 eval_="Y", empty=()):
        self.prove_cls = prove_cls
        self.down = set(down)
        self.empty = set(empty)
        self.out = dict(commitment=commitment, proof=proof, eval_=eval_)
        self.queries = []

    async def query(self, uids, synapses, timeout):
        self.queries.append((list(uids), synapses, timeout))
        out = []
        for u, s in zip(uids, synapses):
            r = self.prove_cls(index=s.index, poly=[])
            if u in self.down:
                r.status_code = 408
            elif s.poly and u not in self.empty:
                r.commitment = self.out["commitment"]
                if s.alpha:
                    r.proof, r.eval_ = self.out["proof"], self.out["eval_"]
            out.append(r)
        return out


class Broken:
    """A transport whose query raises (an unknown uid in the JAX package's
    MockTransport raises KeyError the same way)."""

    async def query(self, uids, synapses, timeout):
        raise KeyError(uids[0])


def _both(fn):
    return {name: fn(mod, prove) for name, (mod, prove) in PACKAGES.items()}


# -- where the two clients agree -------------------------------------------------

def test_ping_uids_matches_jax():
    got = _both(lambda mod, prove: asyncio.run(mod.ping_uids(
        Net(prove, down={1, 4}), [0, 1, 2, 3, 4], timeout=2.0)))
    assert got["torch"] == got["jax"] == ([0, 2, 3], [1, 4])


_SCORES = [0.9, 0.1, 0.2, 0.8, 0.3, 0.4, 0.5, 0.6, 0.7, 0.05]


@pytest.mark.parametrize("scores,unavailable,down,limit,want", [
    (_SCORES, (), (), 3, [0, 3]),
    (_SCORES, (0,), (), 3, [3, 8]),
    (_SCORES, (), (0,), 3, [3]),
    ([0.0] * 6, (), (2,), 2, None),
    ([0.3, 0.4], (0, 1), (), 3, []),
], ids=["top", "top unavailable", "top down", "cold start", "no pool"])
def test_get_query_uids_matches_jax(scores, unavailable, down, limit, want):
    """Without ties at the top, the same uids; at a cold start the whole
    pool, sampled down to ``limit`` from one seed (the port's client
    stream and the JAX coordinator's start from the same seed)."""
    def run(mod, prove):
        coord = Coord(scores, seed=11, unavailable=unavailable)
        kw = {"rng": random.Random(11)} if mod is tclient else {}
        return asyncio.run(mod.get_query_uids(
            coord, Net(prove, down=down), top_fraction=0.2, limit=limit,
            **kw))
    got = _both(run)
    assert got["torch"] == got["jax"]
    if want is None:                    # the cold start: a sample of the pool
        assert len(got["torch"]) == limit and 2 not in got["torch"]
    else:
        assert got["torch"] == want


def test_subnet_client_fan_out_matches_jax():
    """commit and open fan out to the pinned pool (or, after
    ``reset_pool``, a uniform sample from the coordinator) with the
    coordinator's timeout, and take the first answer; verify is the
    coordinator's pairing check; no answer gives None."""
    def run(mod, prove):
        coord = Coord([0.9, 0.8, 0.1, 0.2, 0.0], seed=3)
        net = Net(prove, empty={0})
        client = mod.SubnetClient(coord, net, sample_size=2)
        pool = client.discover(top_fraction=0.5)
        out = [pool, client.commit(["a", "b"], index=1),
               client.open(["a"], "X", index=2)]
        client.reset_pool()
        out += [client.commit(["c"]),
                client.verify("C", "X", "Y", "good-proof", index=3),
                client.verify("C", "X", "Y", "bad", index=3)]
        silent = mod.SubnetClient(coord, Net(prove, empty={0, 1, 2, 3, 4}))
        out += [silent.commit(["a"]), silent.open(["a"], "X")]
        queries = [(u, [(s.index, s.poly, s.alpha) for s in syns], t)
                   for u, syns, t in net.queries]
        return out, queries, coord.verified
    got = _both(run)
    out, queries, _ = got["torch"]
    assert got["torch"] == got["jax"]
    assert out[1:] == ["C", ("Y", "P"), "C", True, False, None, None]
    assert queries[1][0] == queries[2][0] == out[0]
    assert [t for _, _, t in queries] == [3.0, 7.0, 7.0, 7.0]


def test_exports_match_jax():
    assert tapi.__all__ == japi.__all__
    assert tapi.SubnetClient is tclient.SubnetClient


# -- the four faults of the original, both sides -----------------------------

def test_ping_of_a_failing_transport_marks_every_uid_failed():
    """client.py:31 — the JAX client lets the transport's error out; the
    port marks every uid failed, as the reference's try/except does."""
    with pytest.raises(KeyError):
        asyncio.run(jclient.ping_uids(Broken(), [5, 6]))
    assert asyncio.run(tclient.ping_uids(Broken(), [5, 6])) == ([], [5, 6])


def test_ties_at_the_top_keep_the_top_scorers():
    """client.py:58 — three uids tie at the highest score: the JAX client's
    strict ``>`` empties the top quantile and pings the whole pool (low
    scorers included); the port keeps the three. At a cold start (every
    score 0) both take the whole pool."""
    scores = [0.5, 0.1, 0.5, 0.0, 0.5, 0.2]

    def run(mod, prove, scores=scores):
        net = Net(prove)
        kw = {"rng": random.Random(0)} if mod is tclient else {}
        uids = asyncio.run(mod.get_query_uids(
            Coord(scores), net, top_fraction=0.4, limit=6, **kw))
        return sorted(uids), net.queries[0][0]
    got = _both(run)
    assert got["jax"] == ([0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5])
    assert got["torch"] == ([0, 2, 4], [0, 2, 4])
    cold = _both(lambda mod, prove: run(mod, prove, [0.0] * 4))
    assert cold["torch"] == cold["jax"] == ([0, 1, 2, 3], [0, 1, 2, 3])


def test_discovery_leaves_the_coordinators_stream_alone():
    """client.py:62 — the JAX client samples down to ``limit`` from
    ``coordinator.rng``, so discovery moves the stream that picks the
    challenge rounds' uids; the port samples from the client's own
    ``random.Random(seed)``: the same uids here (both streams start from
    seed 0), and the coordinator's next round draws what it would have
    drawn without the client."""
    untouched = Coord([0.0] * 8).get_random_uids(4)
    got = {}
    for name, (mod, prove) in PACKAGES.items():
        coord = Coord([0.0] * 8)
        client = mod.SubnetClient(coord, Net(prove), sample_size=3)
        got[name] = (client.discover(), coord.get_random_uids(4))
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == untouched
    assert got["jax"][1] != untouched
    again = tclient.SubnetClient(Coord([0.0] * 8), Net(TProve),
                                 sample_size=3).discover()
    assert again == got["torch"][0]


@pytest.mark.filterwarnings(
    "ignore:coroutine 'get_query_uids' was never awaited")
def test_async_callers_await_get_query_uids():
    """client.py:82 — ``discover`` runs its own event loop, so from a
    coroutine it raises in both packages; the port's docstring steers such
    callers to ``await get_query_uids``, which the JAX
    client's does not. Awaited, both give the same uids."""
    async def inside(mod, prove):
        coord = Coord([0.9, 0.8, 0.1], seed=2)
        client = mod.SubnetClient(coord, Net(prove), sample_size=2)
        with pytest.raises(RuntimeError):
            client.discover()
        kw = {"rng": client.rng} if mod is tclient else {}
        return await mod.get_query_uids(coord, client.transport,
                                        limit=client.sample_size, **kw)
    got = _both(lambda mod, prove: asyncio.run(inside(mod, prove)))
    assert got["torch"] == got["jax"] == [0]
    assert "await get_query_uids" in tclient.SubnetClient.discover.__doc__
    assert "await" not in jclient.SubnetClient.discover.__doc__


# -- one real row through the port's workers ------------------------------------

N = 8
TAU = 0x5EED0F7A015F1BED


def test_commit_open_verify_of_a_toy_row_through_port_workers():
    """SubnetClient over a port Coordinator and LocalTransport to two port
    Workers on the CPU, bases [τ^j]G1 for a known τ: the commitment is
    [f(τ)]G1, the evaluation f(x) and the proof [q(τ)]G1 (oracle), the
    pairing verify accepts them and rejects a tampered proof."""
    g = o.G1.from_affine(o.G1_GEN)
    g2 = o.G2.from_affine(o.G2_GEN)
    bases = tcv.g1_encode([o.G1.mul(g, pow(TAU, j, o.R)) for j in range(N)])
    srs = Srs(scale=3, machines_scale=0, g1_x=bases,
              worker_bases=bases[None], lagrange_y=tcv.g1_encode([g]),
              g2_gen=g2, g2_tau_x=o.G2.mul(g2, TAU), g2_tau_y=g2)
    hotkeys = ["w0", "w1"]
    coord = trt.Coordinator(srs, trt.CoordinatorConfig(timeout=600.0),
                            hotkeys=hotkeys, seed=4)
    workers = {u: trt.Worker(srs, members=set(hotkeys)) for u in (0, 1)}
    client = tclient.SubnetClient(coord, trt.LocalTransport(workers),
                                  sample_size=1, seed=4)
    assert client.discover() in ([0], [1])

    rng = np.random.default_rng(31)
    row = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(N)]
    x = int.from_bytes(rng.bytes(40), "little") % o.R
    poly = enc.poly_to_b64(row)
    com = client.commit(poly)
    assert o.G1.to_affine(enc.g1_from_b64(com)) == o.G1.to_affine(
        o.G1.mul(g, o.poly_eval(row, TAU)))
    y, proof = client.open(poly, enc.fr_to_b64(x))
    assert enc.fr_from_b64(y) == o.poly_eval(row, x)
    q = o.poly_quotient(row, x)
    assert o.G1.to_affine(enc.g1_from_b64(proof)) == o.G1.to_affine(
        o.G1.mul(g, o.poly_eval(q, TAU)))
    assert client.verify(com, enc.fr_to_b64(x), y, proof)
    assert not client.verify(com, enc.fr_to_b64(x), y, com)
