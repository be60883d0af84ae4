"""The measurement path refuses without a card, and imports no JAX:
``benchmark/run.py`` runs in a process of its own."""

import os
import shutil
import subprocess
import sys

from benchmark.spec import HERE

ROOT = os.path.dirname(HERE)
CMD = [sys.executable, "benchmark/run.py", "--workload",
       "default_18_8.prove", "--seed", str(2 ** 31 + 5), "--seconds", "1",
       "--trace", "0"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_without_a_card_it_refuses_and_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_directory_of_only_the_benchmark_cannot_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


_PROBE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.result, benchmark.rank, benchmark.control
import benchmark.reference, benchmark.judge, benchmark.traffic
from benchmark.spec import Spec
spec = Spec({root!r})
for group in ("end_to_end", "per_layer"):
    for m in spec.data[group]:
        spec.reader(m["name"])
{extra}
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _top_level(extra=""):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(
        root=ROOT, extra=extra)], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_harness_and_its_reference_import_no_jax_nor_the_port():
    tops = _top_level()
    assert not tops & {"jax", "jaxlib", "flax", "zkp_subnet_tpu",
                       "zkp_subnet_tpu_torch"}


def test_what_the_run_imports_of_the_port_brings_no_jax():
    tops = _top_level(
        "import zkp_subnet_tpu_torch.parallel.launch\n"
        "import zkp_subnet_tpu_torch.parallel.pianist\n"
        "import zkp_subnet_tpu_torch.models.srs\n"
        "import zkp_subnet_tpu_torch.ops.kernels\n")
    assert "zkp_subnet_tpu_torch" in tops
    # whole top-level names: the port's name begins with the JAX package's
    assert not tops & {"jax", "jaxlib", "flax", "zkp_subnet_tpu"}


def test_forbidden_names_compare_whole():
    sys.path.insert(0, ROOT)
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("zkp_subnet_tpu", None)
        sys.modules["zkp_subnet_tpu_torch.fake"] = object()
        assert "zkp_subnet_tpu" not in run.forbidden_loaded()
        sys.modules["zkp_subnet_tpu.fake"] = object()
        assert "zkp_subnet_tpu" in run.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
