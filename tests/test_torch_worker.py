"""The port's worker (zkp_subnet_tpu_torch/runtime/worker.py) against the JAX
package's prove program, on the same bases, rows and points; the SRS
loader against files the JAX package writes; and the port's freedom from
JAX.

Bases are [τ^j]G1 for a known τ (oracle, numpy seed), so the pairing
verify has its [τ]G2. Outputs are compared as wire strings (b64), which
fixes the affine point: projective representatives differ by engine.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp_subnet_tpu.models.srs import Srs as JSrs
from zkp_subnet_tpu.ops import curve as jcv
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.runtime import worker as jworker
from zkp_subnet_tpu.utils import encoding as enc
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.models.pianist import AggregatedProof
from zkp_subnet_tpu_torch.models.srs import (Srs, from_numpy_points,
                                             to_numpy_points)
from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.runtime.worker import Prove, Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TAU = 0x5EED0F7A015F1BED


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    g = o.G1.from_affine(o.G1_GEN)
    g2 = o.G2.from_affine(o.G2_GEN)
    bases = tcv.g1_encode([o.G1.mul(g, pow(TAU, j, o.R)) for j in range(N)])
    srs = Srs(scale=4, machines_scale=0, g1_x=bases,
              worker_bases=bases[None], lagrange_y=tcv.g1_encode([g]),
              g2_gen=g2, g2_tau_x=o.G2.mul(g2, TAU), g2_tau_y=g2)
    rng = np.random.default_rng(21)
    rows = [[int.from_bytes(rng.bytes(40), "little") % o.R
             for _ in range(N)] for _ in range(2)]
    x = int.from_bytes(rng.bytes(40), "little") % o.R
    return Worker(srs), jnp.asarray(to_numpy_points(bases)), rows, x


def _jax_prove(jbases, row, x):
    """The JAX package's worker program on the same inputs, as b64."""
    fn = jworker._prove_row_fn(N, None)
    limbs = enc.b64_to_limbs(enc.poly_to_b64(row))
    com, y, prf = fn(jbases, JFR.to_mont(jnp.asarray(limbs)),
                     JFR.encode([x])[0])
    com, y, prf = jax.block_until_ready((com, y, prf))
    return (enc.g1_to_b64(jcv.g1_decode(np.asarray(com)[None])[0]),
            enc.fr_to_b64(JFR.decode(np.asarray(y)[None])[0]),
            enc.g1_to_b64(jcv.g1_decode(np.asarray(prf)[None])[0]))


def test_forward_matches_jax_prove_program(setup):
    worker, jbases, rows, x = setup
    resp = worker.forward(Prove(index=0, poly=enc.poly_to_b64(rows[0]),
                                alpha=enc.fr_to_b64(x)))
    assert (resp.commitment, resp.eval_, resp.proof) == \
        _jax_prove(jbases, rows[0], x)
    assert resp.poly == [] and resp.process_time > 0
    assert enc.fr_from_b64(resp.eval_) == o.poly_eval(rows[0], x)
    assert worker.worker_verify(0, resp.proof, resp.alpha, resp.eval_,
                                resp.commitment)


def test_commit_only_ping_and_rpc_surface(setup):
    worker, jbases, rows, x = setup
    poly = enc.poly_to_b64(rows[1])
    resp = worker.forward(Prove(index=0, poly=poly))
    com, y, prf = _jax_prove(jbases, rows[1], 0)
    assert resp.commitment == com
    assert resp.eval_ is None and resp.proof is None
    assert worker.worker_commit(0, poly) == com
    assert worker.worker_open(0, poly, enc.fr_to_b64(0)) == (y, prf)
    assert worker.warmup() > 0
    ping = worker.forward(Prove(index=0, poly=[]))
    assert ping.commitment is None and ping.process_time == 0.0
    # a malformed row is logged and the request comes back unchanged
    bad = Prove(index=0, poly=["not base64!"], alpha=enc.fr_to_b64(x))
    assert worker.forward(bad) is bad


def test_verify_rejects_tampered_proof(setup):
    worker, _, rows, x = setup
    resp = worker.forward(Prove(index=0, poly=enc.poly_to_b64(rows[0]),
                                alpha=enc.fr_to_b64(x)))
    other = enc.g1_to_b64(o.G1.from_affine(o.G1_GEN))
    assert not worker.worker_verify(0, other, resp.alpha, resp.eval_,
                                    resp.commitment)
    assert not worker.worker_verify(0, "garbage", resp.alpha, resp.eval_,
                                    resp.commitment)


@pytest.mark.parametrize("sidecar", [False, True])
def test_srs_load_reads_jax_files(tmp_path, monkeypatch, sidecar):
    """Srs.load of a JAX-saved SRS equals from_numpy_points of its arrays
    (the .npz layout, and the .bases.npy sidecar of large scales)."""
    if sidecar:
        monkeypatch.setattr(JSrs, "_SIDE_CAR_LIMIT", 0)
    g = o.G1.from_affine(o.G1_GEN)
    g2 = o.G2.from_affine(o.G2_GEN)
    pts = to_numpy_points(tcv.g1_encode(
        [o.G1.mul(g, 3 + j) for j in range(8)]))
    jsrs = JSrs(scale=2, machines_scale=1, g1_x=pts[:2],
                worker_bases=pts[:4].reshape(2, 2, 3, 24),
                lagrange_y=pts[6:8], g2_gen=g2, g2_tau_x=o.G2.mul(g2, 5),
                g2_tau_y=o.G2.mul(g2, 7))
    setup_p, pre_p = str(tmp_path / "setup.npz"), str(tmp_path / "pre.npz")
    jsrs.save(setup_p, pre_p)
    assert os.path.exists(pre_p + ".bases.npy") == sidecar
    srs = Srs.load(setup_p, pre_p, device="cpu")
    assert torch.equal(srs.g1_x, from_numpy_points(pts[:2]))
    assert torch.equal(srs.worker_bases,
                       from_numpy_points(pts[:4].reshape(2, 2, 3, 24)))
    assert torch.equal(srs.lagrange_y, from_numpy_points(pts[6:8]))
    for got, want in ((srs.g2_gen, g2), (srs.g2_tau_x, jsrs.g2_tau_x),
                      (srs.g2_tau_y, jsrs.g2_tau_y)):
        assert o.G2.to_affine(got) == o.G2.to_affine(want)
    assert (srs.row_size, srs.machines) == (2, 2)
    assert np.array_equal(to_numpy_points(srs.worker_bases),
                          pts[:4].reshape(2, 2, 3, 24))


def test_srs_entry_points_want_the_card_unless_told(tmp_path):
    """With no device argument the SRS entry points mean the CUDA device and
    raise where there is none; they never pick the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    sp, pp = str(tmp_path / "s.npz"), str(tmp_path / "p.npz")
    for call in (lambda: Srs.generate(2, 1),
                 lambda: Srs.generate_to_disk(2, 1, sp, pp),
                 lambda: Srs.load(sp, pp),
                 lambda: Srs.from_numpy({}),
                 lambda: AggregatedProof.from_numpy({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(sp)


def test_port_never_imports_jax():
    """The worker and all it imports load without JAX and without the JAX
    package (tests/test_torch_utils.py holds the same for every module)."""
    mods = ["zkp_subnet_tpu_torch.runtime.worker"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.startswith('zkp_subnet_tpu.') or "
            "m == 'zkp_subnet_tpu' for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
