"""The port's multi-device path (zkp_subnet_tpu_torch/parallel/: make_mesh,
shard_srs, prove, fft, launch, dryrun; runtime/transport.py:MeshTransport)
on gloo worlds of CPU processes.

Two worlds run once each for the module, each rank a process of this file
(``python tests/test_torch_parallel.py ...``, which imports torch and the
port and no JAX): 2 ranks as (batch 1, machines 2) and 4 ranks as
(batch 2, machines 2), over the session SRS (scale 6 / machines_scale 2:
M = 4 workers, rows of T = 16) that the port loads from the files the JAX
package saves of it. Every rank proves the same numpy-made rows, α and β
(each its own shard), runs ``fft`` in all four (left, inverse)
combinations and a ``MeshTransport`` query on fixed synapses, and writes
what it holds. The shards are held, assembled:

- against the port's single-process ``pianist.commit_all``/``open_all``/
  ``aggregate`` and ``LocalTransport`` on the same inputs
  (``tests/test_torch_pianist.py`` and ``test_torch_runtime.py`` hold those
  bit-exact to the JAX package), and against the trapdoor oracle;
- the transforms directly against the JAX package's ``par.fft`` on the
  8-virtual-device mesh of ``tests/conftest.py``, shaped (2, 4) as
  ``tests/test_parallel.py`` shapes it;
- and, in one test marked ``slow``, the 4-rank world's shards directly
  against the JAX package's ``par.prove`` and ``MeshTransport.query``.

The 2-rank world also scores two rounds through ``Coordinator`` +
``MeshTransport`` and one round with a corrupt uid; the 4-rank world also
runs ``dryrun_multichip(4)`` inside itself. A third world is ``launch``
over ``--coordinator-address`` (2 processes), a fourth the 2-process
``dryrun_multichip(2)``. Tolerance: none (canonical integers, affine
points, b64 strings compared exactly).
"""

import asyncio
import json
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.models import pianist as pn
from zkp_subnet_tpu_torch.models.srs import (Srs, _lagrange_coeffs_at,
                                             _trapdoor, default_paths)
from zkp_subnet_tpu_torch.ops import curve as cv
from zkp_subnet_tpu_torch.ops.field import FQ, FR
from zkp_subnet_tpu_torch.parallel import dryrun, launch
from zkp_subnet_tpu_torch.parallel import pianist as par
from zkp_subnet_tpu_torch.runtime.protocol import Prove
from zkp_subnet_tpu_torch.utils import encoding as enc
from zkp_subnet_tpu_torch.utils import native
from zkp_subnet_tpu_torch.utils import oracle as o

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2                      # challenges of the 4-rank world; the 2-rank
WORLDS = {2: (1, 2), 4: (2, 2)}   # world proves the first: (batch, machines)
BAD_UID = 2
WORLD_TIMEOUT = 600
G = o.G1.from_affine(o.G1_GEN)


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(argvs):
    return [subprocess.Popen([sys.executable, *a], env=_env(), cwd=REPO,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for a in argvs]


def _finish(procs, what):
    """Every process's output; fails naming the first rank that failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what}, rank {r}:\n{out[-4000:]}"
    return outs


# -- the rank program --------------------------------------------------------

def _rank(argv):
    """One rank of a test world: argv = n_batch n_machines rank address
    srs_dir out_dir [--scored] [--dryrun]."""
    n_batch, n_machines, rank = (int(a) for a in argv[:3])
    address, srs_dir, out = argv[3:6]
    torch.set_num_threads(1)
    n = n_batch * n_machines
    launch.initialize_distributed(address, n, rank, "cpu")
    with open(os.path.join(out, "inputs.json")) as f:
        inputs = json.load(f)
    srs = Srs.load(*default_paths(srs_dir, inputs["scale"],
                                  inputs["machines_scale"]), lazy=True,
                   device="cpu")
    mesh = par.make_mesh(n_machines, n_batch, device="cpu")
    sharded = par.shard_srs(srs, mesh)
    b = mesh.get_local_rank(par.BATCH_AXIS)
    ml = sharded.worker_bases.shape[0]
    lo = mesh.get_local_rank(par.MACHINES_AXIS) * ml
    arrays = np.load(os.path.join(out, "inputs.npz"))
    rows = FR.from_limbs16(arrays["rows"][b:b + 1, lo:lo + ml])
    alpha = FR.from_limbs16(arrays["alpha"])
    beta = FR.from_limbs16(arrays["beta"][b:b + 1])

    res = dict(b=b, lo=lo)
    proof = par.prove(sharded, rows, alpha, beta, mesh)
    for k, v in proof._asdict().items():
        res[k] = (FR.to_limbs16(v) if k in ("evals", "value")
                  else FQ.to_limbs16(v))
    for left in (True, False):
        for inverse in (False, True):
            res[f"fft_{int(left)}{int(inverse)}"] = FR.to_limbs16(
                par.fft(rows, mesh, left=left, inverse=inverse))

    syns = [Prove(**s) for s in inputs["synapses"]]
    uids = list(range(len(syns)))
    log = {"query": [dict(r.__dict__) for r in asyncio.run(
        trt.MeshTransport(sharded, mesh).query(uids, syns, 600.0))],
        "memmap": isinstance(srs.worker_bases, np.memmap)}

    if "--scored" in argv:
        m = srs.machines
        hotkeys = [f"mesh{i}" for i in range(m)]
        cfg = trt.CoordinatorConfig(
            sample_size=m, timeout=600.0, epoch_length=1,
            state_dir=os.path.join(out, f"state{rank}"))
        coord = trt.Coordinator(srs, cfg, hotkeys=hotkeys, seed=5)
        rounds = []
        forward = coord.forward

        async def keep(transport, timeout=None):
            got = await forward(transport, timeout)
            rounds.append({"rewards": got[2].tolist(), "times": sorted(
                {r.process_time for r in got[1]})})
            return got
        coord.forward = keep
        ok = asyncio.run(coord.run(trt.MeshTransport(sharded, mesh),
                                   rounds=2))
        uids_w, weights = coord.set_weights()
        bad = trt.Coordinator(srs, trt.CoordinatorConfig(
            sample_size=m, timeout=600.0), hotkeys=hotkeys, seed=6)
        _, resps, rewards = bad.run_round(trt.MeshTransport(
            sharded, mesh, corrupt_uids=[BAD_UID]))
        log["scored"] = {
            "ok": ok, "rounds": rounds, "scores": coord.scores.tolist(),
            "weights": weights.tolist(), "weight_uids": uids_w.tolist(),
            "corrupt_rewards": rewards.tolist(),
            "corrupt_scores": bad.scores.tolist(),
            "corrupt_times": sorted({r.process_time for r in resps})}
    if "--dryrun" in argv:
        dryrun.dryrun_multichip(n, device="cpu")
        log["dryrun"] = True
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(log, f)


# -- fixtures ----------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(srs, tmp_path_factory):
    """The session SRS saved by the JAX package and loaded by the port, and
    the inputs from a numpy seed: rows (B, M, T) ints, α, β (B,)."""
    base = tmp_path_factory.mktemp("mesh")
    srs_dir, side_dir = str(base / "srs"), str(base / "srs_sidecar")
    os.makedirs(srs_dir)
    os.makedirs(side_dir)
    srs.save(*default_paths(srs_dir, srs.scale, srs.machines_scale))
    tsrs = Srs.load(*default_paths(srs_dir, srs.scale, srs.machines_scale),
                    device="cpu")
    # the same SRS with its worker bases in a sidecar, as at scale 24/8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Srs, "_SIDE_CAR_LIMIT", 0)
        tsrs.save(*default_paths(side_dir, srs.scale, srs.machines_scale))
    m, t = tsrs.machines, tsrs.row_size
    rng = np.random.default_rng(0x9A7A11E1)
    draw = lambda: int.from_bytes(rng.bytes(40), "little") % o.R  # noqa: E731
    rows = [[[draw() for _ in range(t)] for _ in range(m)] for _ in range(B)]
    alpha, beta = draw(), [draw() for _ in range(B)]
    alpha_b64 = enc.fr_to_b64(alpha)
    synapses = [{"index": i, "poly": enc.poly_to_b64(rows[0][i]),
                 "alpha": alpha_b64} for i in range(m)]
    return dict(srs=tsrs, srs_dirs={2: side_dir, 4: srs_dir}, base=base,
                rows=rows, alpha=alpha, beta=beta, synapses=synapses, m=m,
                t=t)


def _mont(ints, shape):
    return FR.encode(list(np.asarray(ints, dtype=object).reshape(-1))
                     ).reshape(shape + (FR.L,))


@pytest.fixture(scope="module", autouse=True)
def worlds(case):
    """The 2-rank and 4-rank worlds, the 2-process launch and the spawned
    dry run, started with the module, so that they run while the tests in
    this process do their own work; ``wait(name)`` collects each."""
    m, t = case["m"], case["t"]
    native.load()                     # built once, before the ranks load it
    started = {}
    for n, (nb, nm) in WORLDS.items():
        out = case["base"] / f"world{n}"
        out.mkdir()
        rows = _mont(case["rows"][:nb], (nb, m, t))
        np.savez(out / "inputs.npz", rows=FR.to_limbs16(rows),
                 alpha=FR.to_limbs16(FR.encode([case["alpha"]])[0]),
                 beta=FR.to_limbs16(FR.encode(case["beta"][:nb])))
        with open(out / "inputs.json", "w") as f:
            json.dump({"scale": case["srs"].scale,
                       "machines_scale": case["srs"].machines_scale,
                       "synapses": case["synapses"]}, f)
        address = f"127.0.0.1:{_free_port()}"
        flags = ["--scored"] if n == 2 else ["--dryrun"]
        started[n] = (out, _start([[__file__, str(nb), str(nm), str(r),
                                    address, case["srs_dirs"][n], str(out),
                                    *flags] for r in range(n)]))
    srs_dir = str(case["base"] / "launch")
    address = f"127.0.0.1:{_free_port()}"
    started["launch"] = (None, _start([[
        "-m", "zkp_subnet_tpu_torch.parallel.launch", "--device", "cpu",
        "--rounds", "1", "--scale", "4", "--machines-scale", "1",
        "--srs-dir", srs_dir, "--seed", "13", "--coordinator-address",
        address, "--num-processes", "2", "--process-id", str(r)]
        for r in range(2)]))
    started["dryrun"] = (None, _start([[
        "-c", "from zkp_subnet_tpu_torch.parallel.dryrun import "
        "dryrun_multichip; dryrun_multichip(2, device='cpu')"]]))
    done = {}

    def wait(name):
        if name not in done:
            out, procs = started[name]
            logs = _finish(procs, f"world {name}")
            if out is None:
                done[name] = logs
            else:
                done[name] = [
                    (dict(np.load(out / f"rank{r}.npz")),
                     json.loads((out / f"rank{r}.json").read_text()))
                    for r in range(len(procs))]
        return done[name]
    yield wait
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _assemble(ranks, key, nb, m):
    """A per-worker output of every rank in its global (nb, M, ...) place."""
    first = ranks[0][0][key]
    out = np.zeros((nb, m) + first.shape[2:], first.dtype)
    for res, _ in ranks:
        piece = res[key]
        out[int(res["b"]), int(res["lo"]):int(res["lo"]) + piece.shape[1]] = \
            piece[0]
    return out


def _affine(points16):
    return cv.g1_affine(FQ.from_limbs16(points16))


def _ints(limbs16):
    return FR.decode(FR.from_limbs16(limbs16))


@pytest.fixture(scope="module")
def single(case):
    """The port's single-process round on the same inputs, a challenge at a
    time: (commitments, evals, proofs, AggregatedProof)."""
    tsrs, m, t = case["srs"], case["m"], case["t"]
    alpha = FR.encode([case["alpha"]])[0]
    out = []
    for b in range(B):
        rows = _mont(case["rows"][b], (m, t))
        coms = pn.commit_all(tsrs, rows)
        ys, prfs = pn.open_all(tsrs, rows, alpha)
        beta = FR.encode([case["beta"][b]])[0]
        agg = pn.aggregate(tsrs, coms, prfs, ys, beta)
        out.append((coms, ys, prfs, agg))
    return out


@pytest.fixture(scope="module")
def oracle(case):
    """Per challenge, the trapdoor's values: commitments, evals, proofs of
    every worker and C, W, C_y, W_y, f(α, β) as affine points / ints."""
    # here, not at the top: the rank processes run this file without the
    # conftest, which imports JAX
    from conftest import TEST_SRS_SEED
    tau_x, tau_y = _trapdoor(None, None, TEST_SRS_SEED)
    m, alpha = case["m"], case["alpha"]
    keys = _lagrange_coeffs_at(tau_y, m)
    mul = lambda k: o.G1.to_affine(o.G1.mul(G, k % o.R))  # noqa: E731
    inv = lambda x: pow(x % o.R, o.R - 2, o.R)  # noqa: E731
    out = []
    for b in range(B):
        rows = case["rows"][b]
        f_tau = [o.poly_eval(r, tau_x) for r in rows]
        ys = [o.poly_eval(r, alpha) for r in rows]
        q_tau = [(f - y) * inv(tau_x - alpha) for f, y in zip(f_tau, ys)]
        beta = case["beta"][b]
        lag_b = _lagrange_coeffs_at(beta, m)
        value = sum(y * k for y, k in zip(ys, lag_b)) % o.R
        y_tau = sum(y * k for y, k in zip(ys, keys)) % o.R
        out.append(dict(
            coms=[mul(k * f) for k, f in zip(keys, f_tau)], evals=ys,
            prfs=[mul(k * q) for k, q in zip(keys, q_tau)],
            C=mul(sum(k * f for k, f in zip(keys, f_tau))),
            W=mul(sum(k * q for k, q in zip(keys, q_tau))),
            C_y=mul(y_tau), W_y=mul((y_tau - value) * inv(tau_y - beta)),
            value=value))
    return out


# -- no card, no fallback ----------------------------------------------------

def test_without_a_card_nothing_falls_back_to_the_cpu(monkeypatch, capsys,
                                                      tmp_path):
    """With no CUDA device and no ``device="cpu"``: ``make_mesh`` and the dry
    run raise, and ``launch.main`` exits 2 before it loads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1)
    rc = launch.main(["--rounds", "1", "--scale", "4", "--machines-scale",
                      "1", "--srs-dir", str(tmp_path)])
    assert rc == launch.NO_DEVICE == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_a_world_of_its_size():
    """A mesh of more ranks than the world raises with the JAX message; no
    process group is left behind."""
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        par.make_mesh(n_machines=2, n_batch=2, device="cpu")
    assert not torch.distributed.is_initialized()


# -- launch in this process --------------------------------------------------

def test_initialize_distributed_single_process_noop():
    assert launch.initialize_distributed(None, None, None) == 0
    assert launch.initialize_distributed(None, 1, 0) == 0
    assert not torch.distributed.is_initialized()


def test_launch_main_runs_rounds_and_persists_srs(tmp_path, caplog):
    """World size 1 on the CPU: argparse, SRS generate + save, a one-rank
    gloo mesh, two proved rounds; a second run loads the saved SRS. Each
    run ends the process group it started."""
    caplog.set_level(logging.INFO, logger="zkp_subnet_tpu_torch.launch")
    argv = ["--device", "cpu", "--rounds", "2", "--scale", "4",
            "--machines-scale", "1", "--srs-dir", str(tmp_path),
            "--seed", "11"]
    assert launch.main(argv) == 0
    assert all(os.path.exists(p) for p in default_paths(str(tmp_path), 4, 1))
    lines = [r.getMessage() for r in caplog.records]
    assert "slice up: 1 processes, 1 global devices (cpu)" in lines
    assert any("backend gloo" in line for line in lines)
    assert [x for x in lines if x.endswith("sub-proofs aggregated")] == [
        "round 0: 2 sub-proofs aggregated", "round 1: 2 sub-proofs aggregated"]
    assert not torch.distributed.is_initialized()
    caplog.clear()
    assert launch.main(argv[:2] + ["--rounds", "1"] + argv[4:]) == 0
    lines = [r.getMessage() for r in caplog.records]
    assert any(x.startswith("loaded SRS from") for x in lines)
    assert "round 0: 2 sub-proofs aggregated" in lines
    assert not torch.distributed.is_initialized()


def test_launch_main_rejects_bad_flags():
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--scale", "not-a-number"])


# -- the distributed NTT -----------------------------------------------------

def test_transforms_match_jax_par_fft(worlds, case):
    """``fft`` in all four (left, inverse) combinations, assembled from both
    worlds' shards, equals the JAX package's ``par.fft`` on the
    8-virtual-device mesh shaped (2, 4)."""
    import jax
    import jax.numpy as jnp
    from zkp_subnet_tpu import parallel as jpar
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    m, t = case["m"], case["t"]
    mesh = jpar.make_mesh(n_machines=m, n_batch=B)
    rows = jnp.asarray(FR.to_limbs16(_mont(case["rows"], (B, m, t))))
    want = {f"fft_{int(left)}{int(inverse)}": np.asarray(jpar.fft(
        rows, mesh, left=left, inverse=inverse))
        for left in (True, False) for inverse in (False, True)}
    for n in sorted(WORLDS):
        nb = WORLDS[n][0]
        for key, out in want.items():
            got = _assemble(worlds(n), key, nb, m)
            assert np.array_equal(got, out[:nb]), (key, n)


# -- the distributed prove ---------------------------------------------------

@pytest.mark.parametrize("n", sorted(WORLDS))
def test_shards_match_single_process_and_oracle(worlds, case, single,
                                                oracle, n):
    """Every worker's commitment, eval and proof, assembled from the shards,
    and each challenge's C, W, C_y, W_y and f(α, β) on every rank equal the
    single-process round and the trapdoor oracle."""
    ranks = worlds(n)
    nb, m = WORLDS[n][0], case["m"]
    coms = _assemble(ranks, "commitments", nb, m)
    evals = _assemble(ranks, "evals", nb, m)
    prfs = _assemble(ranks, "proofs", nb, m)
    for b in range(nb):
        s_coms, s_ys, s_prfs, agg = single[b]
        want = oracle[b]
        assert _affine(coms[b]) == cv.g1_affine(s_coms) == want["coms"]
        assert _ints(evals[b]) == FR.decode(s_ys) == want["evals"]
        assert _affine(prfs[b]) == cv.g1_affine(s_prfs) == want["prfs"]
        mine = [res for res, _ in ranks if int(res["b"]) == b]
        for key, field, oracle_key in (
                ("commitment", "commitment", "C"),
                ("proof_x", "proof_x", "W"),
                ("commitment_y", "commitment_y", "C_y"),
                ("proof_y", "proof_y", "W_y")):
            got = {_affine(res[key])[0] for res in mine}
            assert got == {cv.g1_affine(getattr(agg, field))[0]} \
                == {want[oracle_key]}, key
        assert {_ints(res["value"])[0] for res in mine} \
            == {FR.decode(agg.value)[0], want["value"]}


def test_shards_read_from_a_sidecar_memmap(worlds):
    """The 2-rank world loads the SRS lazily from a sidecar (as at scale
    24/8): ``shard_srs`` reads each rank's rows of the memmap; the 4-rank
    world's SRS has its bases in the .npz."""
    assert all(log["memmap"] for _, log in worlds(2))
    assert not any(log["memmap"] for _, log in worlds(4))


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_every_rank_holds_the_same_aggregate(worlds, n):
    """The aggregation runs replicated: the ranks of a batch row hold the
    same limbs."""
    ranks = worlds(n)
    for key in ("commitment", "proof_x", "commitment_y", "proof_y",
                "value"):
        by_row = {}
        for res, _ in ranks:
            by_row.setdefault(int(res["b"]), []).append(res[key])
        for row in by_row.values():
            assert all(np.array_equal(row[0], x) for x in row[1:]), key


def test_distributed_proof_verifies_and_tampered_does_not(worlds, case):
    """The 4-rank world's aggregated proofs pass both pairing checks; a
    proof with W swapped for C, or the value moved by one, does not."""
    ranks = worlds(4)
    tsrs, m = case["srs"], case["m"]
    evals = _assemble(ranks, "evals", B, m)
    for b in range(B):
        res = next(r for r, _ in ranks if int(r["b"]) == b)
        agg = pn.AggregatedProof(
            commitment=FQ.from_limbs16(res["commitment"][0]),
            proof_x=FQ.from_limbs16(res["proof_x"][0]),
            evals=FR.from_limbs16(evals[b]),
            commitment_y=FQ.from_limbs16(res["commitment_y"][0]),
            proof_y=FQ.from_limbs16(res["proof_y"][0]),
            value=FR.from_limbs16(res["value"][0]))
        args = (case["alpha"], case["beta"][b])
        assert pn.verify_aggregated(tsrs, agg, *args)
        bad_w = pn.AggregatedProof(**{**agg.__dict__,
                                      "proof_x": agg.commitment})
        assert not pn.verify_aggregated(tsrs, bad_w, *args)
        bad_v = pn.AggregatedProof(**{**agg.__dict__, "value": FR.add(
            agg.value, FR.encode([1])[0])})
        assert not pn.verify_aggregated(tsrs, bad_v, *args)


# -- MeshTransport -----------------------------------------------------------

def _wire(r):
    return (r["index"], r["eval_"], r["commitment"], r["proof"],
            r["status_code"])


@pytest.fixture(scope="module")
def local_responses(case):
    """The fixed synapses through ``LocalTransport`` (one port ``Worker``),
    one synapse a query: several at once run in executor threads that
    would fight over the interpreter lock (a toy row's plain ladder is
    thousands of small tensor operations), ~3x slower here."""
    worker = trt.Worker(case["srs"])
    transport = trt.LocalTransport({i: worker for i in range(case["m"])})
    return [asyncio.run(transport.query([i], [Prove(**s)], 600.0))[0]
            for i, s in enumerate(case["synapses"])]


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_mesh_transport_query_matches_local_transport(worlds,
                                                      local_responses, n):
    """Every rank returns every worker's response, the same b64 strings as
    ``LocalTransport``'s, all with one ``process_time`` (the largest prove
    clock over the ranks, so the same on every rank)."""
    want = [(r.index, r.eval_, r.commitment, r.proof, r.status_code)
            for r in local_responses]
    assert all(w[2] and w[3] for w in want)
    times = set()
    for _, log in worlds(n):
        assert [_wire(r) for r in log["query"]] == want
        times |= {r["process_time"] for r in log["query"]}
    assert len(times) == 1 and times.pop() > 0.0


def test_mesh_transport_scored_rounds(worlds, case):
    """``Coordinator.run`` over ``MeshTransport`` in the 2-rank world: both
    rounds ok, every reward > 0 and one ``process_time`` a round, scores
    > 0 and weights reaching 65535, the same on both ranks."""
    logs = [log["scored"] for _, log in worlds(2)]
    for s in logs:
        assert s["ok"] == 2
        assert len(s["rounds"]) == 2
        for r in s["rounds"]:
            assert len(r["rewards"]) == case["m"]
            assert all(x > 0 for x in r["rewards"])
            assert len(r["times"]) == 1 and r["times"][0] > 0.0
        assert max(s["scores"]) > 0.0 and max(s["weights"]) == 65535
    assert logs[0]["scores"] == logs[1]["scores"]
    assert logs[0]["weights"] == logs[1]["weights"]


def test_mesh_transport_corrupt_uid_scores_zero(worlds, case):
    """One corrupt uid: exactly one reward 0.0, the others > 0, one
    ``process_time`` for the round (the reference's corruption scheme,
    tests/test_validator.py:79-86, on the mesh path)."""
    m = case["m"]
    for _, log in worlds(2):
        s = log["scored"]
        rewards = s["corrupt_rewards"]
        assert sum(x > 0 for x in rewards) == m - 1
        assert sum(x == 0.0 for x in rewards) == 1
        scores = s["corrupt_scores"]
        assert scores[BAD_UID] == 0.0
        assert all(x > 0 for i, x in enumerate(scores) if i != BAD_UID)
        assert len(s["corrupt_times"]) == 1


# -- the other worlds: launch over two processes, the dry runs ---------------

def test_two_process_launch(worlds):
    """Two processes rendezvous over ``--coordinator-address`` on gloo and
    prove one round: the lead narrates the world and the round."""
    lead = worlds("launch")[0]
    assert "slice up: 2 processes, 2 global devices (cpu)" in lead
    assert "backend gloo" in lead
    assert "round 0: 2 sub-proofs aggregated" in lead


def test_dryrun_multichip_4_in_its_world(worlds):
    """``dryrun_multichip(4)`` called on every rank of the 4-rank world runs
    there: NTT both ways, a verified prove and a scored round."""
    assert all(log.get("dryrun") for _, log in worlds(4))


def test_dryrun_multichip_2_spawns_ranks(worlds):
    """``dryrun_multichip(2)`` called in a process with no world spawns two
    gloo ranks (this module's fourth world), each of which checks its NTT,
    its verified prove and its scored round."""
    worlds("dryrun")


# -- the JAX package's distributed prove itself (slow: its XLA compiles) -----

@pytest.mark.slow
def test_four_rank_world_matches_jax_par_prove_and_mesh_transport(
        worlds, case, srs):
    """The 4-rank world's shards against the JAX package's ``par.prove`` on
    a (2, 2) mesh of the virtual devices, limb for limb where the engines
    agree on projective form, else as affine points; its query responses
    against the JAX ``MeshTransport.query`` on the same synapses."""
    import jax
    import jax.numpy as jnp
    from zkp_subnet_tpu import parallel as jpar
    from zkp_subnet_tpu.ops import curve as jcv
    from zkp_subnet_tpu.runtime import MeshTransport as JMeshTransport
    from zkp_subnet_tpu.runtime.protocol import Prove as JProve
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual devices of tests/conftest.py")
    m, t = case["m"], case["t"]
    mesh = jpar.make_mesh(n_machines=2, n_batch=B)
    sharded = jpar.shard_srs(srs, mesh)
    rows = jnp.asarray(FR.to_limbs16(_mont(case["rows"], (B, m, t))))
    alpha = jnp.asarray(FR.to_limbs16(FR.encode([case["alpha"]])[0]))
    beta = jnp.asarray(FR.to_limbs16(FR.encode(case["beta"])))
    out = jpar.prove(sharded, rows, alpha, beta, mesh, window_bits=8)
    ranks = worlds(4)

    def jaffine(points):
        return [o.G1.to_affine(p) for p in
                jcv.g1_decode(np.asarray(points).reshape(-1, 3, 24))]
    for key in ("commitments", "proofs"):
        got = _assemble(ranks, key, B, m)
        assert _affine(got.reshape(-1, 3, 24)) == jaffine(getattr(out, key))
    assert np.array_equal(_assemble(ranks, "evals", B, m),
                          np.asarray(out.evals))
    for res, _ in ranks:
        b = int(res["b"])
        for key in ("commitment", "proof_x", "commitment_y", "proof_y"):
            assert _affine(res[key]) == jaffine(getattr(out, key)[b]), key
        assert np.array_equal(res["value"][0], np.asarray(out.value[b]))

    transport = JMeshTransport(sharded, mesh, window_bits=8)
    syns = [JProve(**s) for s in case["synapses"]]
    want = asyncio.run(transport.query(list(range(m)), syns, 600.0))
    for _, log in ranks:
        assert [_wire(r) for r in log["query"]] == [
            (r.index, r.eval_, r.commitment, r.proof, r.status_code)
            for r in want]


if __name__ == "__main__":
    _rank(sys.argv[1:])
