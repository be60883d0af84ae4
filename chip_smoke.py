#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``zkp_subnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. device: the card's name, and ``name, power.limit`` from nvidia-smi;
2. build: the three CUDA sources under ``zkp_subnet_tpu_torch/csrc/`` with
   nvcc for sm_90a (registers and spills from ``-Xptxas -v``);
3. kernels vs plain: every kernel on the card against its plain PyTorch
   version on CPU copies of the same inputs, random and edge cases, with
   tolerance zero (integer arithmetic: canonical integers and affine points
   must be equal); then each kernel's time beside its plain version's, both
   on the card, at the main path's shapes;
4. main path: a 2^16-base SRS slice [τ^j]G1 built on the card, a ``Worker``
   over it, and three 2^16-coefficient ``Prove`` requests (two with a
   challenge point, one commit-only), each checked by the trapdoor τ and
   the pairing verify, with kernel launch counts; then the median of warm
   commit+open requests and the peak device memory.

The last lines are the kernel table as JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from zkp_subnet_tpu_torch._shared import encoding as enc
from zkp_subnet_tpu_torch._shared import oracle as o
from zkp_subnet_tpu_torch.models.srs import Srs
from zkp_subnet_tpu_torch.ops import curve as cv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops.field import (FQ, FR, fr_add_plain,
                                            fr_mul_plain)
from zkp_subnet_tpu_torch.runtime.worker import Prove, Worker

LOG_N = 16
SEED = 20260301
# the publicly known trapdoor of bench.py (TAU, bench.py:68): lets the
# self-check recompute every output with O(1) oracle scalar multiplications
TAU = 0x1F2E3D4C5B6A79880123456789ABCDEF1122334455667788
WARM_REQUESTS = 5

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "g1_add": ("zkp_subnet_tpu_torch/csrc/g1.cu",
               "zkp_subnet_tpu/ops/pallas_g1.py:181"),
    "g1_double": ("zkp_subnet_tpu_torch/csrc/g1.cu",
                  "zkp_subnet_tpu/ops/pallas_g1.py:181"),
    "msm_buckets": ("zkp_subnet_tpu_torch/csrc/msm.cu",
                    "zkp_subnet_tpu/ops/msm.py:202"),
    "msm_reduce": ("zkp_subnet_tpu_torch/csrc/msm.cu",
                   "zkp_subnet_tpu/ops/msm.py:303"),
    "msm_combine": ("zkp_subnet_tpu_torch/csrc/msm.cu",
                    "zkp_subnet_tpu/ops/msm.py:384"),
    "fr_mul": ("zkp_subnet_tpu_torch/csrc/fr.cu",
               "zkp_subnet_tpu/ops/pallas_g1.py:181"),
    "fr_add": ("zkp_subnet_tpu_torch/csrc/fr.cu",
               "zkp_subnet_tpu/ops/pallas_g1.py:181"),
}


def say(*args):
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- inputs ------------------------------------------------------------------

def random_points(rng, n, device):
    """n on-curve points P_i = [a + i·s]G of known discrete log, in
    projective form with random Z (so the complete formulas see general
    inputs). Returns the (n, 3, 12) tensor and the discrete logs."""
    g = o.G1.from_affine(o.G1_GEN)
    a, s = (int(v) for v in rng.integers(1, 1 << 62, 2))
    step, p = o.G1.mul(g, s), o.G1.mul(g, a)
    xs, ys, zs = [], [], []
    for i in range(n):
        x, y = o.G1.to_affine(p)
        lam = int(rng.integers(1, 1 << 62)) * (i + 1) % o.Q or 1
        xs.append(x * lam % o.Q)
        ys.append(y * lam % o.Q)
        zs.append(lam)
        p = o.G1.add(p, step)
    pts = cv.g1_pack(FQ.encode(xs, device), FQ.encode(ys, device),
                     FQ.encode(zs, device))
    return pts, [(a + i * s) % o.R for i in range(n)]


def random_fr(rng, n, device):
    vals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    vals[:4] = [0, 1, FR.p - 1, FR.p - 2]
    return FR.encode(vals, device)


def random_scalar_limbs(rng, n) -> np.ndarray:
    """(n, 16) uint32 canonical 16-bit limbs of uniform-ish values < r (the
    top limb is drawn below r's top limb 0x73ED)."""
    limbs = rng.integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    limbs[:, 15] = rng.integers(0, 0x73ED, n, dtype=np.uint32)
    return limbs


def limbs_to_ints(limbs: np.ndarray):
    raw = np.ascontiguousarray(limbs.astype("<u2")).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


# -- comparison and timing ---------------------------------------------------

def same_points(got, want) -> int:
    """0 if the two point tensors are equal as affine points, else the
    largest absolute difference of an affine coordinate."""
    got_c, want_c = got.cpu(), want.cpu()
    if torch.equal(got_c, want_c):
        return 0
    err = 0
    for a, b in zip(cv.g1_affine(got_c), cv.g1_affine(want_c)):
        if a != b:
            a, b = a or (0, 0), b or (0, 0)
            err = max(err, abs(a[0] - b[0]), abs(a[1] - b[1]), 1)
    return err


def same_fr(got, want) -> int:
    """0 if equal, else the largest absolute difference of the integers."""
    if torch.equal(got.cpu(), want.cpu()):
        return 0
    g, w = FR.decode(got), FR.decode(want)
    return max([abs(a - b) for a, b in zip(g, w)] + [0])


def time_cuda(fn, reps):
    """(mean ms per call over ``reps`` calls after one warm-up call, the
    warm-up call's result), timed with CUDA events."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# -- phases ------------------------------------------------------------------

def phase_kernels(rng, dev):
    """Kernel vs plain on random and edge inputs; then times at the main
    path's shapes. Returns {name: {"max_abs_err", "ms", "plain_ms"}}."""
    res = {name: {"max_abs_err": 0} for name in KERNELS}

    def record(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        check(err == 0, f"{name}: kernel != plain (max abs err {err})")

    # K1: random points plus P+P, P+(−P), ∞+P, P+∞, ∞+∞
    n = 4096
    p = random_points(rng, n, dev)[0]
    q = random_points(rng, n, dev)[0]
    inf = cv.g1_infinity((1,), dev)
    q[0] = p[0]                                        # P + P
    q[1] = cv.g1_neg(p[1:2].cpu())[0].to(dev)          # P + (−P)
    p[2] = inf[0]                                      # ∞ + P
    q[3] = inf[0]                                      # P + ∞
    p[4], q[4] = inf[0], inf[0]                        # ∞ + ∞
    p[5] = p[6] = q[6]                                 # equal projective
    record("g1_add", same_points(kernels.g1_add(p, q),
                                 cv.g1_add_plain(p.cpu(), q.cpu())))
    record("g1_double", same_points(kernels.g1_double(p),
                                    cv.g1_double_plain(p.cpu())))
    say(f"[kernels] K1 g1_add / g1_double: {n} points incl. P+P, P+(-P), "
        "inf+P, P+inf, inf+inf: equal to plain")

    # K3: random elements with 0, 1, r−1, r−2, and a broadcast operand
    a = random_fr(rng, n, dev)
    b = random_fr(rng, n, dev)
    b[4:8] = a[0:4]
    one = FR.ints_to_limbs([1], dev)
    for name, kern, plain in (("fr_mul", kernels.fr_mul, fr_mul_plain),
                              ("fr_add", kernels.fr_add, fr_add_plain)):
        record(name, same_fr(kern(a, b), plain(a.cpu(), b.cpu())))
        record(name, same_fr(kern(a, one), plain(a.cpu(), one.cpu())))
        record(name, same_fr(kern(b[:1], a), plain(b[:1].cpu(),
                                                       a.cpu())))
    say(f"[kernels] K3 fr_mul / fr_add: {n} elements incl. 0, 1, r-1, r-2 "
        "and broadcast operands: equal to plain")

    # K2: random scalars at 4096 points; zero, all-equal and half-zero
    # scalars at 512. Each kernel against its plain version (the reduce on
    # the first 64 rows: the plain running sum is 510 serial CPU adds), and
    # the whole kernel-path MSM against the oracle via the known dlogs.
    pts, dlogs = random_points(rng, n, dev)
    k = random_scalar_limbs(rng, 1)
    cases = [("random", n, random_scalar_limbs(rng, n)),
             ("zero", 512, np.zeros((512, 16), np.uint32)),
             ("all-equal", 512, np.repeat(k, 512, axis=0)),
             ("half zero", 512, np.concatenate(
                 [np.zeros((256, 16), np.uint32), np.repeat(k, 256, 0)]))]
    for label, m, limbs in cases:
        pp, sc = pts[:m].contiguous(), FR.from_limbs16(limbs, dev)
        groups = tmsm._groups(m)
        runs = tmsm.bucket_runs(sc, groups)
        bk = kernels.msm_buckets(pp, *runs)
        bp = tmsm.msm_buckets_plain(pp.cpu(), *(t.cpu() for t in runs))
        record("msm_buckets", same_points(bk, bp))
        sk = kernels.msm_reduce(bk[:64].contiguous())
        record("msm_reduce", same_points(sk, tmsm.msm_reduce_plain(
            bp[:64])))
        wins = sk[:tmsm.NUM_WINDOWS].contiguous()
        record("msm_combine", same_points(
            kernels.msm_combine(wins, 8)[None],
            tmsm.msm_combine_plain(wins.cpu())[None]))
        total = sum(a * b for a, b in zip(limbs_to_ints(limbs), dlogs)) % o.R
        want = o.G1.to_affine(o.G1.mul(o.G1.from_affine(o.G1_GEN), total))
        check(cv.g1_affine(tmsm.msm(pp, sc))[0] == want,
              f"msm ({label}): result != oracle")
        say(f"[kernels] K2 msm ({label} scalars, {m} points, {groups} "
            "groups): buckets, reduce and combine equal to plain; the MSM "
            "equals the oracle")

    # the main path's shapes: kernel and plain both on the card, timed, and
    # their results compared
    n = 1 << LOG_N
    p = random_points(rng, 256, dev)[0].repeat(n // 256, 1, 1)
    q = p.roll(1, 0).contiguous()
    a, b = random_fr(rng, n, dev), random_fr(rng, n, dev)
    sc = FR.from_limbs16(random_scalar_limbs(rng, n), dev)
    runs = tmsm.bucket_runs(sc, tmsm._groups(n))
    bk = kernels.msm_buckets(p, *runs)
    sk = kernels.msm_reduce(bk)
    wins = sk[:tmsm.NUM_WINDOWS].contiguous()
    pts, fr = same_points, same_fr
    timings = {
        "g1_add": (lambda: kernels.g1_add(p, q),
                   lambda: cv.g1_add_plain(p, q), 20, pts),
        "g1_double": (lambda: kernels.g1_double(p),
                      lambda: cv.g1_double_plain(p), 20, pts),
        "fr_mul": (lambda: kernels.fr_mul(a, b),
                   lambda: fr_mul_plain(a, b), 50, fr),
        "fr_add": (lambda: kernels.fr_add(a, b),
                   lambda: fr_add_plain(a, b), 50, fr),
        "msm_buckets": (lambda: kernels.msm_buckets(p, *runs),
                        lambda: tmsm.msm_buckets_plain(p, *runs), 5, pts),
        "msm_reduce": (lambda: kernels.msm_reduce(bk),
                       lambda: tmsm.msm_reduce_plain(bk), 5, pts),
        "msm_combine": (lambda: kernels.msm_combine(wins, 8)[None],
                        lambda: tmsm.msm_combine_plain(wins)[None], 5, pts),
    }
    for name, (kern, plain, reps, same) in timings.items():
        res[name]["ms"], got = time_cuda(kern, reps)
        res[name]["plain_ms"], want = time_cuda(plain, 1)
        record(name, same(got, want))
        say(f"[kernels] {name} at the main path's shape {tuple(got.shape)}: "
            f"equal to plain; kernel {res[name]['ms']:.4f} ms, plain "
            f"{res[name]['plain_ms']:.2f} ms")
    return res


def build_srs(dev):
    """A one-worker SRS (scale 16, machines_scale 0) whose row is the
    2^16-base slice [τ^j]G1: τ^j by K3, the points by g1_scalar_mul (K1)."""
    n = 1 << LOG_N
    powers = FR.from_mont(FR.powers(FR.encode([TAU], dev)[0], n))
    gen = cv.g1_encode([o.G1.from_affine(o.G1_GEN)], dev)
    bases = cv.g1_scalar_mul(gen.expand(n, 3, 12).contiguous(), powers)
    g = o.G1.from_affine(o.G1_GEN)
    for j in (0, 1, 2, n // 2 + 1, n - 1):
        want = o.G1.to_affine(o.G1.mul(g, pow(TAU, j, o.R)))
        check(cv.g1_affine(bases[j])[0] == want, f"SRS base {j} != [tau^{j}]G1")
    g2 = o.G2.from_affine(o.G2_GEN)
    return Srs(scale=LOG_N, machines_scale=0, g1_x=bases,
               worker_bases=bases[None], lagrange_y=gen,
               g2_gen=g2, g2_tau_x=o.G2.mul(g2, TAU),
               g2_tau_y=g2)        # τ_Y is unused with a single worker


def selfcheck(resp, row_ints, x_int, commit_only):
    """The trapdoor check of bench.py:selfcheck_prove on wire outputs."""
    g = o.G1.from_affine(o.G1_GEN)
    f_tau = o.poly_eval(row_ints, TAU)
    check(resp.commitment is not None, "response carries no commitment")
    check(o.G1.to_affine(enc.g1_from_b64(resp.commitment))
          == o.G1.to_affine(o.G1.mul(g, f_tau)), "commitment != [f(tau)]G1")
    if commit_only:
        check(resp.eval_ is None and resp.proof is None,
              "commit-only response carries an opening")
        return
    check(resp.eval_ is not None and resp.proof is not None,
          "response carries no eval/proof")
    y = o.poly_eval(row_ints, x_int)
    check(enc.fr_from_b64(resp.eval_) == y, "eval != f(x)")
    q_tau = (f_tau - y) * pow((TAU - x_int) % o.R, o.R - 2, o.R) % o.R
    check(o.G1.to_affine(enc.g1_from_b64(resp.proof))
          == o.G1.to_affine(o.G1.mul(g, q_tau)), "proof != [q(tau)]G1")


def phase_main_path(rng, dev):
    n = 1 << LOG_N
    kernels.reset_launches()
    t0 = time.perf_counter()
    srs = build_srs(dev)
    torch.cuda.synchronize()
    say(f"[main] SRS slice of {n} bases [tau^j]G1 built on the card in "
        f"{time.perf_counter() - t0:.2f} s; 5 bases match the oracle")
    worker = Worker(srs)

    def request(commit_only):
        limbs = random_scalar_limbs(rng, n)
        x_int = None if commit_only else \
            int.from_bytes(rng.bytes(32), "little") % o.R
        syn = Prove(index=0, poly=enc.limbs_to_b64(limbs),
                    alpha=None if commit_only else enc.fr_to_b64(x_int))
        t = time.perf_counter()
        resp = worker.forward(syn)
        torch.cuda.synchronize()
        return resp, limbs, x_int, time.perf_counter() - t

    first_s = None
    for i, commit_only in enumerate((False, False, True)):
        before = dict(kernels.LAUNCHES)
        resp, limbs, x_int, dt = request(commit_only)
        first_s = dt if first_s is None else first_s
        used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        selfcheck(resp, limbs_to_ints(limbs), x_int, commit_only)
        if not commit_only:
            check(worker.worker_verify(0, resp.proof, resp.alpha, resp.eval_,
                                       resp.commitment),
                  "worker_verify rejected the proof")
        for k in ("g1_add", "msm_buckets", "msm_reduce", "msm_combine",
                  "fr_mul", "fr_add"):
            check(used[k] > 0, f"request {i}: no {k} launch")
        kind = "commit-only" if commit_only else "commit+open"
        say(f"[main] request {i} ({kind}, {n} coefficients): {dt:.3f} s, "
            f"trapdoor self-check PASS"
            + ("" if commit_only else ", pairing verify PASS")
            + f"; launches {used}")
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"main path never launched {k}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(WARM_REQUESTS):
        resp, _, _, dt = request(False)
        check(resp.commitment is not None and resp.proof is not None,
              "warm request failed")
        times.append(dt)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times) * 1e3
    say(f"[main] first request {first_s:.3f} s (includes warm-up); warm "
        f"commit+open of a 2^{LOG_N} row: median {med:.2f} ms over "
        f"{len(times)} ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms); "
        f"peak device memory {peak / 2**20:.1f} MiB")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    info = kernels.build(force=True)
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"[build] nvcc sm_90a, {len(kernels.SOURCES)} sources: "
        f"{info['seconds']:.1f} s")
    for ln in regs:
        say(f"[build]   {ln}")

    rng = np.random.default_rng(SEED)
    try:
        res = phase_kernels(rng, dev)
        launches = phase_main_path(rng, dev)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[k], "max_abs_err": res[k]["max_abs_err"],
              "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"]}
             for k, (src, rep) in KERNELS.items()]
    say(json.dumps({"kernels": table}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
