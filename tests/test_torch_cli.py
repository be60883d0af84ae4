"""The port's CLI (``python -m zkp_subnet_tpu_torch``, zkp_subnet_tpu_torch/
__main__.py) against the JAX package's CLI, at scale 4 / machines_scale 1
(two workers, rows of 8), on the CPU (``--device cpu``).

Each package's ``setup`` runs once per module with the same flags and
seed; their files hold the same keys and equal arrays, and their manifests
are the same text. ``check`` of either package accepts the other's files
and prints the same lines, and refuses a flipped byte. The round commands
run in process through ``main(argv)``, their printed lines read off
stdout. A commit+open on the CPU takes seconds (the MSMs run the plain
PyTorch versions): the module proves ten rows in all.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from zkp_subnet_tpu.__main__ import main as jmain
from zkp_subnet_tpu_torch import __main__ as cli
from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.__main__ import main
from zkp_subnet_tpu_torch.models.srs import Srs

CPU = ["--device", "cpu"]
SHAPE = ["--scale", "4", "--machines-scale", "1"]
M = 2
COMMANDS = ("setup", "round", "aggregate", "run", "check", "serve",
            "localnet")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(d):
    return ["--setup-path", str(d / "setup.npz"),
            "--precompute-path", str(d / "precompute.npz")]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{package: directory} of one ``setup`` by each CLI, same flags, same
    seed, same file names."""
    out = {}
    for name, run, device in (("jax", jmain, []), ("torch", main, CPU)):
        d = tmp_path_factory.mktemp(name)
        assert run(device + ["setup", *_paths(d), *SHAPE,
                             "--generate-setup", "--generate-precompute"]) == 0
        out[name] = d
    return out


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_setup_writes_the_jax_clis_files(dirs):
    """Same keys in the same order, equal arrays and dtypes, and the same
    manifest: file names and digests."""
    for name in ("setup.npz", "precompute.npz"):
        with np.load(dirs["jax"] / name) as a, np.load(dirs["torch"] / name) \
                as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k
    manifest = [(dirs[p] / "setup.npz.sha256").read_text().splitlines()
                for p in ("jax", "torch")]
    assert [line.split()[1] for line in manifest[1]] == \
        ["setup.npz", "precompute.npz"]
    assert manifest[0] == manifest[1]


def test_check_reads_the_other_packages_files(dirs, tmp_path, capsys):
    """Each package's ``check`` passes the other's files with the same
    printed lines, and returns 1 once a byte of the precompute is
    flipped."""
    lines = {}
    for name, run, device, files in (("torch", main, CPU, "jax"),
                                     ("jax", jmain, [], "torch")):
        assert run(device + ["check", *_paths(dirs[files])]) == 0
        lines[name] = _lines(capsys)
    assert lines["torch"] == lines["jax"]
    assert lines["torch"][-1] == "all checks passed"
    assert sum(line.startswith("  PASS") for line in lines["torch"]) == 9
    for name in ("setup.npz", "precompute.npz", "setup.npz.sha256"):
        shutil.copy(dirs["torch"] / name, tmp_path / name)
    raw = bytearray((tmp_path / "precompute.npz").read_bytes())
    raw[-1] ^= 0xFF
    (tmp_path / "precompute.npz").write_bytes(bytes(raw))
    assert main(CPU + ["check", *_paths(tmp_path)]) == 1
    assert "  FAIL  sha256 precompute.npz" in _lines(capsys)
    assert jmain(["check", *_paths(tmp_path)]) == 1


def test_setup_refuses_to_overwrite_and_a_mismatched_pair(dirs, tmp_path,
                                                           capsys):
    assert main(CPU + ["setup", *_paths(dirs["torch"]), *SHAPE,
                       "--generate-setup"]) == 1
    assert "refusing to overwrite" in capsys.readouterr().err
    # a precompute of another scale beside the setup: both CLIs refuse it
    assert main(CPU + ["setup", *_paths(tmp_path), "--scale", "3",
                       "--machines-scale", "1", "--generate-setup",
                       "--generate-precompute"]) == 0
    mixed = ["--setup-path", str(dirs["torch"] / "setup.npz"),
             "--precompute-path", str(tmp_path / "precompute.npz")]
    for run, device in ((main, CPU), (jmain, [])):
        with pytest.raises(ValueError, match="setup/precompute mismatch"):
            run(device + ["round", *mixed])


_REWARD = re.compile(r"worker (\d+): reward=(\d\.\d{3}) t=(\d+\.\d+)s")


def test_aggregate_round_verifies(dirs, capsys):
    """Two workers proved in process, each reward > 0, the aggregated proof
    verifies, and the weights line is the JAX CLI's ``dict`` of uid to
    uint16 weight."""
    assert main(CPU + ["aggregate", *_paths(dirs["torch"]), *SHAPE,
                       "--timeout", "600"]) == 0
    captured = capsys.readouterr()
    out = captured.out.splitlines()
    assert re.fullmatch(r"warmup: \d+\.\ds", captured.err.strip())
    rewards = [_REWARD.fullmatch(line) for line in out[:M]]
    assert all(rewards) and sorted(int(r[1]) for r in rewards) == [0, 1]
    assert all(float(r[2]) > 0 for r in rewards)
    assert out[M] == "aggregated bivariate proof verifies: True"
    assert out[M + 1].startswith("weights: ") and len(out) == M + 2
    weights = ast.literal_eval(out[M + 1][len("weights: "):])
    assert sorted(weights) == [0, 1] and max(weights.values()) == 65535
    assert all(type(v) is int and 0 < v <= 65535 for v in weights.values())


def test_run_twice_resumes_from_the_state_file(dirs, tmp_path, monkeypatch,
                                              capsys):
    """The second ``run`` resumes at the step the first saved. The workers'
    warmup (a row proved on the CPU, its line checked by the ``aggregate``
    and ``serve`` tests) is stubbed out: four rows proved, not six."""
    monkeypatch.setattr(trt.Worker, "warmup", lambda self: 0.0)
    state = str(tmp_path / "state")
    argv = CPU + ["run", *_paths(dirs["torch"]), *SHAPE, "--rounds", "1",
                  "--timeout", "600", "--neuron.epoch_length", "1",
                  "--neuron.state_dir", state]
    assert main(argv) == 0
    first = _lines(capsys)
    assert first[0].startswith("1 forwards ok, step=1, last_weights_step=1,")
    assert first[1] == f"state saved to {state}/state.npz"
    assert main(argv) == 0
    second = _lines(capsys)
    assert second[0] == f"resumed from {state}/state.npz at step 1"
    assert second[1].startswith("1 forwards ok, step=2, last_weights_step=2,")
    assert float(second[1].rsplit("=", 1)[1]) > 0


def test_no_cuda_device_and_no_device_flag_refuses_every_command(
        dirs, tmp_path, monkeypatch, capsys):
    """Without a CUDA device and without ``--device``, every command exits
    with code 2 naming the missing CUDA device, and none of them starts: no
    SRS is loaded or generated, no file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    for name in ("generate", "generate_to_disk", "load"):
        monkeypatch.setattr(Srs, name, classmethod(
            lambda cls, *a, **k: started.append(a)))
    for cmd in COMMANDS:
        extra = ["--generate-setup"] if cmd == "setup" else []
        assert main([cmd, *_paths(tmp_path), *extra]) == cli.NO_DEVICE, cmd
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--device cpu" in err, cmd
    assert started == [] and os.listdir(tmp_path) == []


class _Child:
    """A stand-in ``subprocess.Popen`` of ``localnet``'s ``serve`` child:
    the same worker server, in this process."""

    spawned = []

    def __init__(self, argv, **kwargs):
        self.spawned.append(argv)
        flag = lambda name: argv[argv.index(name) + 1]  # noqa: E731
        srs = Srs.load(flag("--setup-path"), flag("--precompute-path"),
                       lazy=True, device=flag("--device"))
        worker = trt.Worker(srs, trt.WorkerConfig(allow_non_registered=True))
        self.server = trt.WorkerServer(worker, port=int(flag("--port")),
                                       seed=int(flag("--seed"))).start()

    def poll(self):
        return None

    def terminate(self):
        self.server.stop()

    def wait(self, timeout=None):
        return 0


def test_localnet_spawns_serve_children_with_the_device(dirs, monkeypatch,
                                                        capsys):
    """``localnet`` spawns ``python -m zkp_subnet_tpu_torch --device cpu
    serve ...``, one child a worker, and scores one round over HTTP."""
    monkeypatch.setattr(subprocess, "Popen", _Child)
    _Child.spawned.clear()
    assert main(CPU + ["localnet", *_paths(dirs["torch"]), *SHAPE,
                       "--workers", "2", "--rounds", "1",
                       "--no-supervise"]) == 0
    out = _lines(capsys)[-1]
    assert out.startswith("1/1 rounds ok over 2 worker processes; weights: ")
    assert len(_Child.spawned) == 2
    for i, argv in enumerate(_Child.spawned):
        assert argv[:6] == [sys.executable, "-m", "zkp_subnet_tpu_torch",
                            "--device", "cpu", "serve"]
        assert argv[argv.index("--seed") + 1] == str(100 + i)


def test_serve_builds_an_open_worker_server(dirs, monkeypatch, capsys):
    """``serve``: a warmed-up worker that accepts unregistered callers,
    behind a WorkerServer on the given host, port and seed."""
    served = []
    monkeypatch.setattr(trt.WorkerServer, "serve_forever",
                        lambda self: served.append(self)
                        or self._httpd.server_close())
    assert main(CPU + ["serve", *_paths(dirs["torch"]), "--port", "0"]) == 0
    assert capsys.readouterr().err.startswith("warmup: ")
    (server,) = served
    assert server.worker.config.allow_non_registered
    assert server.worker.blacklist("anyone") == (False,
                                                 "allow_non_registered")
    assert server.worker.device == torch.device("cpu")


@pytest.mark.slow
def test_localnet_worker_supervision(dirs):
    """A hard-killed worker process is respawned by the localnet supervisor
    and the coordinator rides through the outage (tests/test_cli.py's
    supervision test, for the port's ``serve`` processes)."""
    proc = subprocess.run(
        [sys.executable, "-m", "zkp_subnet_tpu_torch", "--device", "cpu",
         "localnet", *_paths(dirs["torch"]), *SHAPE, "--workers", "2",
         "--rounds", "3", "--timeout", "120", "--chaos-kill-after", "20"],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    err = proc.stderr
    assert "chaos: killing worker 0" in err
    assert "died rc=" in err and "respawning" in err
    assert "rounds ok over 2 worker processes" in proc.stdout
