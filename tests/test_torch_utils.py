"""The port's own copies of the framework-free modules (oracle, encoding,
native, protocol, config) against the JAX package's originals, and the
port's freedom from JAX and from the JAX package's files.

Inputs come from a numpy seed. Tolerance: none (integers, bytes, strings).
"""

import argparse
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from zkp_subnet_tpu.runtime import config as jconfig
from zkp_subnet_tpu.runtime import protocol as jprotocol
from zkp_subnet_tpu.utils import encoding as jenc
from zkp_subnet_tpu.utils import native as jnative
from zkp_subnet_tpu.utils import oracle as jo
from zkp_subnet_tpu_torch.runtime import config as tconfig
from zkp_subnet_tpu_torch.runtime import protocol as tprotocol
from zkp_subnet_tpu_torch.utils import encoding as tenc
from zkp_subnet_tpu_torch.utils import native as tnative
from zkp_subnet_tpu_torch.utils import oracle as to

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = {"oracle": (jo, to), "encoding": (jenc, tenc),
          "native": (jnative, tnative), "protocol": (jprotocol, tprotocol),
          "config": (jconfig, tconfig)}


def _ints(seed, n, mod):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(56), "little") % mod for _ in range(n)]


def _code(module) -> str:
    """The module's syntax tree without docstrings (comments are not in
    the tree to begin with)."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and \
                isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copy_is_its_own_file_with_the_same_code(name):
    """Each copy lives in the port's tree and differs from the original in
    docstrings and comments only."""
    original, copy = COPIES[name]
    assert os.path.realpath(copy.__file__).startswith(
        os.path.join(REPO, "zkp_subnet_tpu_torch") + os.sep)
    assert os.path.realpath(copy.__file__) != \
        os.path.realpath(original.__file__)
    assert _code(copy) == _code(original)


def test_oracle_field_curve_and_ntt_helpers():
    assert (to.R, to.Q, to.G1_GEN, to.G2_GEN) == \
        (jo.R, jo.Q, jo.G1_GEN, jo.G2_GEN)
    assert [to.fr_root_of_unity(k) for k in (0, 1, 5, 32)] == \
        [jo.fr_root_of_unity(k) for k in (0, 1, 5, 32)]
    xs = _ints(1, 8, to.Q)
    assert [to.fq_inv(x) for x in xs[:4]] == [jo.fq_inv(x) for x in xs[:4]]
    assert [to.fq_sqrt(x * x % to.Q) for x in xs[:4]] == \
        [jo.fq_sqrt(x * x % jo.Q) for x in xs[:4]]
    ks = _ints(2, 3, to.R)
    g, jg = to.G1.from_affine(to.G1_GEN), jo.G1.from_affine(jo.G1_GEN)
    pts = [to.G1.mul(g, k) for k in ks]
    jpts = [jo.G1.mul(jg, k) for k in ks]
    assert [to.G1.to_affine(p) for p in pts] == \
        [jo.G1.to_affine(p) for p in jpts]
    assert to.G1.to_affine(to.G1.add(pts[0], to.G1.neg(pts[1]))) == \
        jo.G1.to_affine(jo.G1.add(jpts[0], jo.G1.neg(jpts[1])))
    assert to.G1.is_infinity(to.G1.add(pts[0], to.G1.neg(pts[0])))
    assert to.g1_in_subgroup_fast(pts[2]) and jo.g1_in_subgroup_fast(jpts[2])
    vals = _ints(3, 16, to.R)
    assert to.ntt(vals) == jo.ntt(vals)
    assert to.intt(to.ntt(vals)) == vals == jo.intt(jo.ntt(vals))
    assert to.poly_eval(vals, ks[0]) == jo.poly_eval(vals, ks[0])
    assert to.poly_quotient(vals, ks[0]) == jo.poly_quotient(vals, ks[0])


def test_oracle_pairing_inputs_and_native_check():
    """G2 helpers that feed the pairing, and one pairing-product check by
    each package's native loader: e([a]G1, [b]G2)·e([−ab]G1, G2) == 1."""
    a, b = _ints(4, 2, to.R)
    g2, jg2 = to.G2.from_affine(to.G2_GEN), jo.G2.from_affine(jo.G2_GEN)
    assert to.G2.to_affine(to.G2.mul(g2, b)) == \
        jo.G2.to_affine(jo.G2.mul(jg2, b))
    assert to.G2.to_affine(to.G2.neg(g2)) == jo.G2.to_affine(jo.G2.neg(jg2))
    results = []
    for o, native in ((to, tnative), (jo, jnative)):
        g = o.G1.from_affine(o.G1_GEN)
        h = o.G2.from_affine(o.G2_GEN)
        good = [(o.G1.mul(g, a), o.G2.mul(h, b)),
                (o.G1.neg(o.G1.mul(g, a * b % o.R)), h)]
        bad = [(o.G1.mul(g, a), o.G2.mul(h, b)), (o.G1.mul(g, 7), h)]
        results.append((native.pairing_check(good), native.pairing_check(bad)))
    assert results == [(True, False), (True, False)]
    # the copy finds the same library under native/ at the repository root
    assert tnative._SO_PATH == jnative._SO_PATH == \
        os.path.join(REPO, "native", "libzkp_native.so")


def test_encoding_scalars_and_rows():
    xs = [0, 1, to.R - 1] + _ints(5, 5, to.R)
    assert [tenc.fr_to_b64(x) for x in xs] == [jenc.fr_to_b64(x) for x in xs]
    assert [tenc.fr_from_b64(tenc.fr_to_b64(x)) for x in xs] == xs
    row = tenc.poly_to_b64(xs)
    assert row == jenc.poly_to_b64(xs)
    assert tenc.poly_from_b64(row) == xs
    limbs = tenc.b64_to_limbs(row)
    assert np.array_equal(limbs, jenc.b64_to_limbs(row))
    assert tenc.limbs_to_b64(limbs) == row == jenc.limbs_to_b64(limbs)
    with pytest.raises(Exception):
        tenc.fr_from_b64("not base64!")


@pytest.mark.parametrize("compressed", [True, False])
def test_encoding_points_round_trip(compressed):
    k = _ints(6, 1, to.R)[0]
    p = to.G1.mul(to.G1.from_affine(to.G1_GEN), k)
    jp = jo.G1.mul(jo.G1.from_affine(jo.G1_GEN), k)
    q = to.G2.mul(to.G2.from_affine(to.G2_GEN), k)
    jq = jo.G2.mul(jo.G2.from_affine(jo.G2_GEN), k)
    for pt in (p, to.G1.infinity()):
        s = tenc.g1_to_b64(pt, compressed)
        assert s == jenc.g1_to_b64(pt, compressed)
        assert to.G1.to_affine(tenc.g1_from_b64(s)) == to.G1.to_affine(pt)
    assert tenc.g1_to_b64(p, compressed) == jenc.g1_to_b64(jp, compressed)
    raw = tenc.g2_to_bytes(q, compressed)
    assert raw == jenc.g2_to_bytes(jq, compressed)
    assert to.G2.to_affine(tenc.g2_from_bytes(raw)) == to.G2.to_affine(q)


def test_prove_and_config_dataclasses():
    fields = [(f.name, f.type, f.default) for f in
              dataclasses.fields(tprotocol.Prove)]
    assert fields == [(f.name, f.type, f.default) for f in
                      dataclasses.fields(jprotocol.Prove)]
    req = tprotocol.Prove(index=3, poly=["AA"], alpha="x")
    resp = req.response(eval_="e", commitment="c", proof="p")
    want = jprotocol.Prove(index=3, poly=["AA"], alpha="x").response(
        eval_="e", commitment="c", proof="p")
    assert dataclasses.asdict(resp) == dataclasses.asdict(want)
    assert resp.poly == [] and req.deserialize() is req
    for cls in ("ProverConfig", "WorkerConfig", "CoordinatorConfig"):
        assert dataclasses.asdict(getattr(tconfig, cls)()) == \
            dataclasses.asdict(getattr(jconfig, cls)())
    argv = ["--scale", "20", "--machines_scale", "4", "--uncompressed",
            "--neuron.name", "w7"]
    got = []
    for mod in (tconfig, jconfig):
        parser = argparse.ArgumentParser()
        mod.add_worker_args(parser)
        got.append(dataclasses.asdict(
            mod.worker_config(parser.parse_args(argv))))
    assert got[0] == got[1] and got[0]["prover"]["scale"] == 20


def test_port_never_imports_jax():
    """In a fresh interpreter every module of the port imports with neither
    ``jax`` nor ``zkp_subnet_tpu`` loaded, and no loaded module's file lies
    under ``zkp_subnet_tpu/``."""
    pkg = os.path.join(REPO, "zkp_subnet_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    assert "zkp_subnet_tpu_torch.models.pianist" in mods
    assert "zkp_subnet_tpu_torch._shared" not in mods
    ref = os.path.join(REPO, "zkp_subnet_tpu") + os.sep
    code = ("import importlib, os, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'zkp_subnet_tpu' or "
            "m.startswith('zkp_subnet_tpu.') for m in sys.modules)\n"
            "files = [getattr(m, '__file__', None) or '' "
            "for m in list(sys.modules.values())]\n"
            f"bad = [f for f in files if os.path.realpath(f).startswith({ref!r})]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
