#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``zkp_subnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. device: the card's name, and ``name, power.limit`` from nvidia-smi;
2. build: the CUDA sources under ``zkp_subnet_tpu_torch/csrc/`` with nvcc
   for sm_90a, one process per source (registers and spills from
   ``-Xptxas -v``);
3. kernels vs plain: every kernel on the card against its plain PyTorch
   version on CPU copies of the same inputs, random and edge cases, with
   tolerance zero (integer arithmetic: canonical integers and affine points
   must be equal; ``msm_reduce`` and ``msm_combine`` limb for limb); then
   each kernel's time beside its plain version's, both on the card, at the
   shapes the paths below give it (CUDA events around a loop of launches:
   for a short kernel that is the host's cost a launch) and the least time
   the card could take for the same work (``bound_ms``); for the two chains
   of K2, the depth of the dependency chain and ms ÷ depth;
4. ``[main]``, the worker's path: a 2^16-base SRS slice [τ^j]G1 built on the
   card, a ``Worker`` over it, and three 2^16-coefficient ``Prove`` requests
   (two with a challenge point, one commit-only), each checked by the
   trapdoor τ and the pairing verify, with kernel launch counts (one launch
   of each K2 kernel a request: the commit's and the opening's MSMs run as
   one batched MSM); then the
   median of warm commit+open requests and the peak device memory;
5. ``[round]``, the coordinator's side of one Pianist round at the row width
   of the reference mainnet (2^16 coefficients a worker) with 16 workers
   (scale 20, machines_scale 4; mainnet has 256 workers, and the other 240
   rows would repeat the same work): ``Srs.generate`` with a known trapdoor
   (oracle samples, a scalar-multiplication cross-check and every point on
   the curve), a 16 × 2^16 challenge in evaluation form brought to
   coefficient rows by the inverse NTT, every row through
   ``Worker.forward`` at one α, ``pianist.aggregate`` at a β (its launch
   count, and its warm time after the path's counts are read) and
   ``pianist.verify_aggregated`` (True, and False after tampering);
6. ``[ntt]``: forward + inverse round trips at 2^16, 2^20 and 2^22;
7. ``[device]``: each kernel's device time with no host work between
   launches (``device_ms``: CUDA events around the replay of a CUDA graph of
   many launches) and torch.profiler's figure beside it; last, because
   graph captures and a profiler run slow every later launch on the
   host.

The launch counts are set to 0 just before each of the two paths and read
just after it. The last lines are the kernel table as JSON, the nvidia-smi
line and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository beside it, the script exits non-zero before printing
a result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from zkp_subnet_tpu_torch.models import pianist
from zkp_subnet_tpu_torch.models.srs import Srs, _lagrange_coeffs_at
from zkp_subnet_tpu_torch.ops import curve as cv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import ntt as tntt
from zkp_subnet_tpu_torch.ops.field import (FQ, FR, fq_add_plain,
                                            fq_mul_plain, fq_sub_plain,
                                            fr_add_plain, fr_mul_plain,
                                            fr_sub_plain)
from zkp_subnet_tpu_torch.runtime.worker import Prove, Worker
from zkp_subnet_tpu_torch.utils import encoding as enc
from zkp_subnet_tpu_torch.utils import oracle as o

LOG_N = 16
SEED = 20260301
# the publicly known trapdoor of bench.py (TAU, bench.py:68): lets the
# self-check recompute every output with O(1) oracle scalar multiplications
TAU = 0x1F2E3D4C5B6A79880123456789ABCDEF1122334455667788
WARM_REQUESTS = 5
# the [round] path: scale 20, machines_scale 4 -> 16 workers x 2^16
ROUND_SCALE, ROUND_MACHINES_SCALE = 20, 4
TAU_Y = 0x0F1E2D3C4B5A69788796A5B4C3D2E1F00112233445566778
NTT_CELL_LOGS = (16, 20, 22)
NTT_CELL_RUNS = 5
AGGREGATE_WARM_RUNS = 5

# the card's peaks for ``bound_ms``: device memory rate from NVIDIA's data
# sheet (H100 SXM); the integer rate is 64 INT32 lanes per SM (Hopper
# architecture white paper) x the SM count x the card's top SM clock as
# nvidia-smi reports it in this run, one 32x32->64 multiply-add counted as
# one lane-operation
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64

# 32-bit integer operations that each function needs: a CIOS product of L
# limbs is 2·L·L multiply-adds (csrc/mont.cuh); an add or subtract is a
# carry chain and a conditional correction, 2·L. The RCB15 point add
# (csrc/g1.cuh) is 14 Fq products and 19 add/subtracts, the double 9 and 9;
# of the products 2 and 1 are by the constant b3 = 12, which needs no
# product but 4 additions (2x, 4x, 8x, 8x + 4x). The bound counts them so,
# although the kernels spend a full product on each: 12 products and 27
# add/subtracts an add, 8 and 13 a double
OPS_FR_MUL, OPS_FR_LIN = 2 * 8 * 8, 2 * 8
OPS_FQ_MUL, OPS_FQ_LIN = 2 * 12 * 12, 2 * 12
OPS_G1_ADD = 12 * OPS_FQ_MUL + 27 * OPS_FQ_LIN
OPS_G1_DOUBLE = 8 * OPS_FQ_MUL + 13 * OPS_FQ_LIN
G1_BYTES, FQ_BYTES, FR_BYTES = 144, 48, 32

_PALLAS = "zkp_subnet_tpu/ops/pallas_g1.py"

_CSRC = "zkp_subnet_tpu_torch/csrc/"

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "g1_add": (_CSRC + "g1.cu", _PALLAS + ":181"),
    "g1_double": (_CSRC + "g1.cu", _PALLAS + ":181"),
    "msm_buckets": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:202"),
    "msm_reduce": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:303"),
    "msm_combine": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:384"),
    "fr_mul": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_add": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_sub": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fq_mul": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fq_add": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fq_sub": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fr_butterfly": (_CSRC + "ntt.cu", _PALLAS + ":219"),
}


def say(*args):
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, int_ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the integer rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def random_field(F, rng, n, device):
    vals = [int.from_bytes(rng.bytes(56), "little") % F.p for _ in range(n)]
    vals[:4] = [0, 1, F.p - 1, F.p - 2]
    return F.encode(vals, device)


def random_fr(rng, n, device):
    return random_field(FR, rng, n, device)


def fr_from_canonical_limbs(limbs: np.ndarray, device) -> torch.Tensor:
    """(..., 16) uint32 canonical limbs → (..., 8) Montgomery on the card."""
    return FR.to_mont(FR.from_limbs16(limbs, device))


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


def same_limbs(got, want) -> int:
    """0 if the two point tensors are equal limb for limb; else at least 1
    (the affine difference where the points differ too)."""
    if torch.equal(got.cpu(), want.cpu()):
        return 0
    return max(same_points(got, want), 1)


def same_field(F, got, want) -> int:
    """0 if equal, else the largest absolute difference of the integers."""
    if torch.equal(got.cpu(), want.cpu()):
        return 0
    g, w = F.decode(got), F.decode(want)
    return max([abs(a - b) for a, b in zip(g, w)] + [1])


def same_fr(got, want) -> int:
    return same_field(FR, got, want)


def same_fq(got, want) -> int:
    return same_field(FQ, got, want)


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


def time_graph(fn, launches):
    """Device ms a launch with no host work between the kernels: CUDA events
    around the second replay of a CUDA graph that holds ``launches`` calls
    of ``fn`` (the wrappers launch on the current stream, which is the
    capture's)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def time_profiler(fn, launches):
    """Device ms a launch as torch.profiler reports it (the kernel events'
    device time over ``launches`` calls), or None where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if "memcpy" in evt.key.lower() or "memset" in evt.key.lower():
            continue
        total_us += getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0.0))
    return total_us / 1e3 / launches if total_us > 0 else None


# -- the paths' shapes ------------------------------------------------------

def path_inputs(rng, dev):
    """Inputs at the shapes the paths give the kernels, on the card."""
    n = 1 << LOG_N
    p = random_points(rng, 256, dev)[0].repeat(n // 256, 1, 1)
    q = p.roll(1, 0).contiguous()
    a, b = random_fr(rng, n, dev), random_fr(rng, n, dev)
    # two MSMs over the same bases, as one request's commit and opening
    sc = FR.from_limbs16(random_scalar_limbs(rng, 2 * n).reshape(2, n, 16),
                         dev)
    runs = tmsm.bucket_runs(sc, tmsm._groups(n))
    runs1 = tmsm.bucket_runs(sc[0], tmsm._groups(n))
    bk = kernels.msm_buckets(p, *runs)
    sk = tmsm.msm_reduce(bk)
    wins = sk[:2 * tmsm.NUM_WINDOWS].view(2, tmsm.NUM_WINDOWS, 3, 12)
    # the [round] path's shapes: the aggregation's 16 evaluations, and the
    # on-curve check over every point of the generated SRS
    m = 1 << ROUND_MACHINES_SCALE
    sa, sb = random_fr(rng, m, dev), random_fr(rng, m, dev)
    n_srs = (1 << ROUND_SCALE) + n + m
    qa = random_field(FQ, rng, 4096, dev).repeat(n_srs // 4096 + 1, 1)[:n_srs]
    qa = qa.contiguous()
    qb = qa.roll(1, 0).contiguous()
    return types.SimpleNamespace(n=n, m=m, n_srs=n_srs, p=p, q=q, a=a, b=b,
                                 sa=sa, sb=sb, qa=qa, qb=qb, runs=runs,
                                 runs1=runs1, bk=bk, wins=wins)


def path_calls(x):
    """{kernel: (kernel call, plain call, repetitions, comparison, bytes
    moved (each input read once, each output written once), integer
    operations)} over ``path_inputs``; K5 is ``time_butterfly``'s."""
    n, m, n_srs = x.n, x.m, x.n_srs
    p, q, a, b, sa, sb, qa, qb = x.p, x.q, x.a, x.b, x.sa, x.sb, x.qa, x.qb
    runs, bk, wins = x.runs, x.bk, x.wins
    pts, limbs, fr, fq = same_points, same_limbs, same_fr, same_fq
    rows_b, nb = runs[1].shape
    bucket_adds = int(runs[2][:, 1:].sum())        # this run's data
    windows = tmsm.NUM_WINDOWS
    return {
        "g1_add": (lambda: kernels.g1_add(p, q),
                   lambda: cv.g1_add_plain(p, q), 20, pts,
                   3 * G1_BYTES * n, OPS_G1_ADD * n),
        "g1_double": (lambda: kernels.g1_double(p),
                      lambda: cv.g1_double_plain(p), 20, pts,
                      2 * G1_BYTES * n, OPS_G1_DOUBLE * n),
        "fr_mul": (lambda: kernels.fr_mul(a, b),
                   lambda: fr_mul_plain(a, b), 50, fr,
                   3 * FR_BYTES * n, OPS_FR_MUL * n),
        "fr_add": (lambda: kernels.fr_add(a, b),
                   lambda: fr_add_plain(a, b), 50, fr,
                   3 * FR_BYTES * n, OPS_FR_LIN * n),
        "fr_sub": (lambda: kernels.fr_sub(sa, sb),
                   lambda: fr_sub_plain(sa, sb), 50, fr,
                   3 * FR_BYTES * m, OPS_FR_LIN * m),
        "fq_mul": (lambda: kernels.fq_mul(qa, qb),
                   lambda: fq_mul_plain(qa, qb), 20, fq,
                   3 * FQ_BYTES * n_srs, OPS_FQ_MUL * n_srs),
        "fq_add": (lambda: kernels.fq_add(qa, qb),
                   lambda: fq_add_plain(qa, qb), 20, fq,
                   3 * FQ_BYTES * n_srs, OPS_FQ_LIN * n_srs),
        "fq_sub": (lambda: kernels.fq_sub(qa, qb),
                   lambda: fq_sub_plain(qa, qb), 20, fq,
                   3 * FQ_BYTES * n_srs, OPS_FQ_LIN * n_srs),
        "msm_buckets": (lambda: kernels.msm_buckets(p, *runs),
                        lambda: tmsm.msm_buckets_plain(p, *runs), 5, pts,
                        G1_BYTES * n + 4 * (runs[0].numel()
                                            + 2 * rows_b * nb)
                        + G1_BYTES * rows_b * nb,
                        OPS_G1_ADD * bucket_adds),
        "msm_reduce": (lambda: kernels.msm_reduce(bk),
                       lambda: tmsm.msm_reduce_plain(bk), 5, limbs,
                       G1_BYTES * rows_b * (nb + 1),
                       OPS_G1_ADD * rows_b * 2 * (nb - 1)),
        "msm_combine": (lambda: kernels.msm_combine(wins, 8),
                        lambda: tmsm.msm_combine_plain(wins), 5, limbs,
                        G1_BYTES * 2 * (windows + 1),
                        2 * windows * (8 * OPS_G1_DOUBLE + OPS_G1_ADD)),
    }


# -- phases ------------------------------------------------------------------

def phase_kernels(rng, dev, int_ops_per_s):
    """Kernel vs plain on random and edge inputs; then times at the paths'
    shapes beside the card's bound for the same work. Returns {name:
    {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by" and for some
    "other_ms"}}. Nothing it allocates outlives it, so the peak memory that
    ``phase_main_path`` reads is the main path's own."""
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
                              ("fr_add", kernels.fr_add, fr_add_plain),
                              ("fr_sub", kernels.fr_sub, fr_sub_plain)):
        record(name, same_fr(kern(a, b), plain(a.cpu(), b.cpu())))
        record(name, same_fr(kern(a, a), plain(a.cpu(), a.cpu())))
        record(name, same_fr(kern(a, one), plain(a.cpu(), one.cpu())))
        record(name, same_fr(kern(b[:1], a), plain(b[:1].cpu(),
                                                       a.cpu())))
    say(f"[kernels] K3 fr_mul / fr_add / fr_sub: {n} elements incl. 0, 1, "
        "r-1, r-2, equal operands and broadcast operands: equal to plain")

    # K4: the same cases over Fq (0, 1, q−1, q−2, equal, broadcast)
    a = random_field(FQ, rng, n, dev)
    b = random_field(FQ, rng, n, dev)
    b[4:8] = a[0:4]
    for name, kern, plain in (("fq_mul", kernels.fq_mul, fq_mul_plain),
                              ("fq_add", kernels.fq_add, fq_add_plain),
                              ("fq_sub", kernels.fq_sub, fq_sub_plain)):
        record(name, same_fq(kern(a, b), plain(a.cpu(), b.cpu())))
        record(name, same_fq(kern(a, a), plain(a.cpu(), a.cpu())))
        record(name, same_fq(kern(a, b[1:2]), plain(a.cpu(), b[1:2].cpu())))
        record(name, same_fq(kern(b[:1], a), plain(b[:1].cpu(), a.cpu())))
    say(f"[kernels] K4 fq_mul / fq_add / fq_sub: {n} elements incl. 0, 1, "
        "q-1, q-2, equal operands and broadcast operands: equal to plain")

    # K5: every stage (first and last included) of a small transform over
    # 3 rows, forward and inverse twiddles, in place
    log_small = 5
    for inverse in (False, True):
        v = random_fr(rng, 3 << log_small, dev).view(3, 1 << log_small, 8)
        ref = v.cpu()
        tw = tntt.twiddles(log_small, inverse, dev)
        for stage in range(1, log_small + 1):
            ref = tntt.fr_butterfly_plain(ref, tw.cpu(), stage)
            check(kernels.fr_butterfly(v, tw, stage).data_ptr()
                  == v.data_ptr(), "fr_butterfly: not in place")
            record("fr_butterfly", same_fr(v, ref))
    say(f"[kernels] K5 fr_butterfly: stages 1..{log_small} of 3 transforms "
        f"of 2^{log_small} incl. 0, 1, r-1, r-2, both directions: equal to "
        "plain")

    # K2: each kernel against its plain version, two MSMs side by side as
    # the main path launches them (the second takes the scalars in reverse
    # order), on random scalars at 4096 points and on edge cases at 512:
    # buckets against the plain version on CPU copies; reduce (every row)
    # and combine (K = 2 and K = 1) limb for limb; then the batched MSM against two single ones and
    # against the oracle via the known dlogs.
    pts, dlogs = random_points(rng, n, dev)
    k = random_scalar_limbs(rng, 1)
    rand512 = random_scalar_limbs(rng, 512)
    cases = [("random", n, random_scalar_limbs(rng, n), None),
             ("zero", 512, np.zeros((512, 16), np.uint32), None),
             ("all-equal", 512, np.repeat(k, 512, axis=0), None),
             ("half zero", 512, np.concatenate(
                 [np.zeros((256, 16), np.uint32), np.repeat(k, 256, 0)]),
              None),
             ("only bucket 255", 512, np.full((512, 16), 0xFFFF, np.uint32),
              None),
             ("only bucket 1", 512, np.full((512, 16), 0x0101, np.uint32),
              None),
             ("every point the same", 512, rand512, 0)]
    for label, m, limbs, repeat in cases:
        if repeat is None:
            pp, logs = pts[:m].contiguous(), dlogs[:m]
        else:
            pp = pts[repeat:repeat + 1].repeat(m, 1, 1)
            logs = [dlogs[repeat]] * m
        both = np.stack([limbs, limbs[::-1]])
        sc = FR.from_limbs16(both, dev)                    # (2, m, 8)
        groups = tmsm._groups(m)
        runs = tmsm.bucket_runs(sc, groups)
        bk = kernels.msm_buckets(pp, *runs)
        bp = tmsm.msm_buckets_plain(pp.cpu(), *(t.cpu() for t in runs))
        record("msm_buckets", same_points(bk, bp))
        sk = kernels.msm_reduce(bk)
        record("msm_reduce", same_limbs(sk, tmsm.msm_reduce_plain(bk)))
        wins = sk[:2 * tmsm.NUM_WINDOWS].view(2, tmsm.NUM_WINDOWS, 3, 12)
        wp = tmsm.msm_combine_plain(wins.cpu())
        record("msm_combine", same_limbs(tmsm.msm_combine(wins), wp))
        record("msm_combine", same_limbs(tmsm.msm_combine(wins[1]), wp[1]))
        many = tmsm.msm_many(pp, sc)
        g = o.G1.from_affine(o.G1_GEN)
        for j in range(2):
            check(torch.equal(many[j], tmsm.msm(pp, sc[j])),
                  f"msm_many ({label}): chain {j} != msm")
            total = sum(a * b for a, b in
                        zip(limbs_to_ints(both[j]), logs)) % o.R
            check(cv.g1_affine(many[j])[0]
                  == o.G1.to_affine(o.G1.mul(g, total)),
                  f"msm_many ({label}): chain {j} != oracle")
        say(f"[kernels] K2 msm ({label}; 2 x {m} scalars, {groups} "
            f"groups, {bk.shape[0]} rows): buckets equal to plain; reduce "
            "and combine (K = 2, K = 1) equal to "
            "plain limb for limb; msm_many equals two msm calls and the "
            "oracle")

    # the paths' shapes: kernel and plain both on the card, timed, and
    # their results compared
    x = path_inputs(rng, dev)
    timings = path_calls(x)
    nb, windows = x.runs[1].shape[1], tmsm.NUM_WINDOWS
    # the longest chain of dependent point operations in the two kernels
    # that are bound by it
    depth = {"msm_reduce": tmsm.reduce_depth(nb),
             "msm_combine": windows * (tmsm.WINDOW_BITS + 1)}
    for name, (kern, plain, reps, same, nbytes, ops) in timings.items():
        r = res[name]
        r["ms"], got = time_cuda(kern, reps)
        r["plain_ms"], want = time_cuda(plain, 1)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, int_ops_per_s)
        record(name, same(got, want))
        del want
        say(f"[kernels] {name} at its path's shape {tuple(got.shape)}: "
            f"equal to plain; kernel {r['ms']:.4f} ms a launch on the "
            f"host's loop, plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        if name in depth:
            say(f"[kernels] {name}: longest chain {depth[name]} dependent "
                f"point operations, {r['ms'] / depth[name] * 1e3:.2f} us "
                "each")
    # the same kernels at one MSM (the shapes a lone commit gives them)
    p, runs1, bk, wins = x.p, x.runs1, x.bk, x.wins
    bk1 = kernels.msm_buckets(p, *runs1)
    groups = tmsm._groups(x.n)
    limbs = same_limbs
    others = [("msm_buckets", "one MSM", limbs,       # against its rows of
               lambda: kernels.msm_buckets(p, *runs1),    # the batched launch
               lambda: bk.view(groups, 2, windows, nb, 3, 12)[:, 0].reshape(
                   -1, nb, 3, 12)),
              ("msm_reduce", "one MSM", limbs,
               lambda: kernels.msm_reduce(bk1),
               lambda: tmsm.msm_reduce_plain(bk1)),
              ("msm_combine", "one MSM", limbs,
               lambda: kernels.msm_combine(wins[0], 8),
               lambda: tmsm.msm_combine_plain(wins[0]))]
    for name, label, same, kern, plain in others:
        ms, got = time_cuda(kern, 5)
        record(name, same(got, plain()))
        say(f"[kernels] {name}, {label}, {tuple(got.shape)}: equal to "
            f"plain; kernel {ms:.4f} ms")
        res[name].setdefault("other_ms", {})[label] = ms
    res["fr_butterfly"].update(time_butterfly(rng, dev, int_ops_per_s,
                                              record))
    say(f"[kernels] fr_sub at 2^{LOG_N} elements (for scale; its path's "
        f"shape is {x.m}): "
        f"{time_cuda(lambda: kernels.fr_sub(x.a, x.b), 50)[0]:.4f} ms")
    return res


def butterfly_inputs(rng, dev):
    """K5's inputs at the [round] path's shape, 16 transforms of 2^16:
    (values (16, 2^16, 8), inverse twiddles)."""
    rows, n = 1 << ROUND_MACHINES_SCALE, 1 << LOG_N
    distinct = min(4096, rows * n)
    base = random_fr(rng, distinct, dev).repeat(rows * n // distinct, 1)
    return (base.view(rows, n, 8).contiguous(),
            tntt.twiddles(LOG_N, True, dev))


def time_butterfly(rng, dev, int_ops_per_s, record):
    """K5 at the [round] path's shape: three stages against the plain
    version on the card, and every stage timed."""
    log_n = LOG_N
    base, tw = butterfly_inputs(rng, dev)
    rows, n = base.shape[:2]
    plain_ms = []
    for stage in (1, log_n // 2, log_n):
        v = base.clone()
        t_plain, want = time_cuda(
            lambda: tntt.fr_butterfly_plain(base, tw, stage), 1)
        kernels.fr_butterfly(v, tw, stage)
        record("fr_butterfly", same_fr(v, want))
        plain_ms.append(t_plain)
        del want
    v = base.clone()
    stage_ms = [time_cuda(lambda s=s: kernels.fr_butterfly(v, tw, s), 10)[0]
                for s in range(1, log_n + 1)]
    pairs = rows * n // 2
    nbytes = 2 * FR_BYTES * rows * n + FR_BYTES * n // 2
    b_ms, b_by = bound(nbytes, pairs * (OPS_FR_MUL + 2 * OPS_FR_LIN),
                       int_ops_per_s)
    mean = statistics.fmean(stage_ms)
    say(f"[kernels] fr_butterfly at its path's shape ({rows}, 2^{log_n}, 8): "
        f"stages 1, {log_n // 2}, {log_n} equal to plain; kernel mean "
        f"{mean:.4f} ms a stage on the host's loop, plain "
        f"{statistics.fmean(plain_ms):.2f} ms, "
        f"bound {b_ms:.5f} ms ({b_by}); stage 1..{log_n} ms: "
        + " ".join(f"{t:.4f}" for t in stage_ms))
    return {"ms": mean, "plain_ms": statistics.fmean(plain_ms),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_device_times(res, dev):
    """Each kernel's device time at its path's shape (inputs built anew),
    with no host work between launches: by graph replay (``device_ms``),
    then by torch.profiler. Last of all phases, because both leave the
    process slower on the host (graph captures until
    ``torch.cuda.empty_cache()``, a profiler run for good), which the
    launch-bound phases would show."""
    rng = np.random.default_rng(SEED + 1)
    calls = {name: call[0] for name, call in
             path_calls(path_inputs(rng, dev)).items()}
    v, tw = butterfly_inputs(rng, dev)
    calls["fr_butterfly"] = lambda: kernels.fr_butterfly(v, tw, LOG_N // 2)
    graph_launches = {"fq_mul": 20, "fq_add": 20, "fq_sub": 20,
                      "msm_buckets": 5, "msm_reduce": 5, "msm_combine": 5}
    for name, r in res.items():
        r["device_ms"] = time_graph(calls[name],
                                    graph_launches.get(name, 100))
    for name, r in res.items():
        r["profiler_ms"] = time_profiler(calls[name], 20)
        prof = ("no device time" if r["profiler_ms"] is None
                else f"{r['profiler_ms']:.4f} ms")
        say(f"[device] {name}: {r['device_ms']:.4f} ms a launch by graph "
            f"replay, {prof} by torch.profiler; host's loop {r['ms']:.4f} "
            f"ms; {r['device_ms'] / r['bound_ms']:.1f} x its bound")


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
        for k in ("g1_add", "fr_mul", "fr_add"):
            check(used[k] > 0, f"request {i}: no {k} launch")
        for k in ("msm_buckets", "msm_reduce", "msm_combine"):
            check(used[k] == 1, f"request {i}: {used[k]} {k} launches, "
                  "not the one of a batched commit + opening")
        kind = "commit-only" if commit_only else "commit+open"
        say(f"[main] request {i} ({kind}, {n} coefficients): {dt:.3f} s, "
            f"trapdoor self-check PASS"
            + ("" if commit_only else ", pairing verify PASS")
            + f"; launches {used}")
    launches = dict(kernels.LAUNCHES)
    for k in ("g1_add", "g1_double", "msm_buckets", "msm_reduce",
              "msm_combine", "fr_mul", "fr_add"):
        check(launches[k] > 0, f"main path never launched {k}")

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


def on_curve_defect(points: torch.Tensor) -> torch.Tensor:
    """Y²Z − (X³ + 4Z³) for an (N, 3, 12) tensor on the card, by K4
    ``fq_mul``/``fq_add``/``fq_sub``: zero for every point on the curve
    (infinity (0 : 1 : 0) included)."""
    X, Y, Z = (c.contiguous() for c in cv.g1_unpack(points))
    lhs = FQ.mont_mul(FQ.sqr(Y), Z)
    x3 = FQ.mont_mul(FQ.sqr(X), X)
    z3 = FQ.mont_mul(FQ.sqr(Z), Z)
    z3_2 = FQ.add(z3, z3)
    return FQ.sub(lhs, FQ.add(x3, FQ.add(z3_2, z3_2)))


def check_srs(srs, lag, dev):
    """The generated SRS against the oracle (samples), against the
    double-and-add scalar multiplication on the card (a sample of the
    comb's outputs), and every point against the curve equation."""
    m, t = srs.machines, srs.row_size
    g = o.G1.from_affine(o.G1_GEN)

    def want(k):
        return o.G1.to_affine(o.G1.mul(g, k % o.R))

    for j in (0, 1, t // 2 + 1, t - 1):
        check(cv.g1_affine(srs.g1_x[j])[0] == want(pow(TAU, j, o.R)),
              f"g1_x[{j}] != [tau_x^{j}]G1")
    for i, j in ((0, 0), (1, 1), (m // 2, t - 1), (m - 1, t // 3)):
        check(cv.g1_affine(srs.worker_bases[i, j])[0]
              == want(lag[i] * pow(TAU, j, o.R)),
              f"worker_bases[{i}, {j}] != [R_{i}(tau_y) tau_x^{j}]G1")
    for i in (0, m - 1):
        check(cv.g1_affine(srs.lagrange_y[i])[0] == want(lag[i]),
              f"lagrange_y[{i}] != [R_{i}(tau_y)]G1")

    # 256 of the comb's outputs against g1_scalar_mul (K1 double + add)
    idx = [(i, (977 * k + 31 * i) % t) for k in range(16) for i in range(m)]
    scalars = cv.fr_to_scalar_limbs(
        [lag[i] * pow(TAU, j, o.R) for i, j in idx], dev)
    gen = cv.g1_encode([g], dev).expand(len(idx), 3, 12).contiguous()
    by_ladder = cv.g1_scalar_mul(gen, scalars)
    ii = torch.tensor([i for i, _ in idx], device=dev)
    jj = torch.tensor([j for _, j in idx], device=dev)
    check(same_points(srs.worker_bases[ii, jj], by_ladder) == 0,
          "comb outputs != double-and-add scalar multiplication")

    everything = torch.cat([srs.g1_x, srs.worker_bases.view(-1, 3, 12),
                            srs.lagrange_y])
    defect = on_curve_defect(everything)
    off = int((defect != 0).any(-1).sum())
    check(off == 0, f"{off} generated points are not on the curve")
    return everything.shape[0], len(idx)


def phase_round(rng, dev):
    """The coordinator's side of one Pianist round (see module docstring).
    Returns the launch counts of this path."""
    m, t = 1 << ROUND_MACHINES_SCALE, 1 << (ROUND_SCALE
                                            - ROUND_MACHINES_SCALE)
    kernels.reset_launches()
    say(f"[round] scale {ROUND_SCALE}, machines_scale "
        f"{ROUND_MACHINES_SCALE}: {m} workers x 2^"
        f"{ROUND_SCALE - ROUND_MACHINES_SCALE} coefficients (the reference "
        "mainnet's row width; 16 workers where mainnet has 256: the one "
        "cut)")

    # 1. SRS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cv.g1_fixed_base_tables(device=dev)
    t_tables = time.perf_counter() - t0
    srs = Srs.generate(ROUND_SCALE, ROUND_MACHINES_SCALE, tau_x=TAU,
                       tau_y=TAU_Y)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    check(srs.device.type == "cuda", "Srs.generate did not use the card")
    lag = _lagrange_coeffs_at(TAU_Y, m)
    n_points, n_ladder = check_srs(srs, lag, dev)
    mb = sum(x.numel() * 4 for x in (srs.g1_x, srs.worker_bases,
                                     srs.lagrange_y)) / 1e6
    say(f"[round] Srs.generate: {t_gen:.2f} s ({t_tables:.2f} s of it the "
        f"comb tables on the host oracle), {mb:.1f} MB of bases on the "
        f"card; 10 samples match the oracle, {n_ladder} comb outputs match "
        f"g1_scalar_mul, all {n_points} points are on the curve")

    # 2. challenge in evaluation form -> coefficient rows
    eval_limbs = random_scalar_limbs(rng, m * t).reshape(m, t, 16)
    evals = fr_from_canonical_limbs(eval_limbs, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = pianist.fft(evals, left=True, inverse=True)
    torch.cuda.synchronize()
    t_intt_first = time.perf_counter() - t0
    t_intt, _ = time_cuda(lambda: pianist.fft(evals, True, True), 5)
    check(torch.equal(pianist.fft(rows, left=True, inverse=False), evals),
          "forward NTT of the coefficient rows != the evaluations")
    row0 = o.intt(limbs_to_ints(eval_limbs[0]))
    check(FR.decode(rows[0]) == row0, "row 0 != oracle.intt")
    say(f"[round] pianist.fft(left, inverse) of {m} x 2^"
        f"{ROUND_SCALE - ROUND_MACHINES_SCALE}: first call "
        f"{t_intt_first * 1e3:.2f} ms (builds the twiddles), then "
        f"{t_intt:.3f} ms mean of 5; forward NTT gives the evaluations "
        "back; row 0 equals oracle.intt")

    # 3. every row through the worker's entry point at one alpha
    worker = Worker(srs)
    alpha = int.from_bytes(rng.bytes(32), "little") % o.R
    beta = int.from_bytes(rng.bytes(32), "little") % o.R
    row_limbs = FR.to_limbs16(FR.from_mont(rows))       # canonical
    g = o.G1.from_affine(o.G1_GEN)
    coms, prfs, ys, times = [], [], [], []
    for i in range(m):
        syn = Prove(index=i, poly=enc.limbs_to_b64(row_limbs[i]),
                    alpha=enc.fr_to_b64(alpha))
        t0 = time.perf_counter()
        resp = worker.forward(syn)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(resp.commitment is not None and resp.proof is not None
              and resp.eval_ is not None, f"row {i}: no proof came back")
        ints = row0 if i == 0 else limbs_to_ints(row_limbs[i])
        f_tau = o.poly_eval(ints, TAU)
        y = o.poly_eval(ints, alpha)
        q_tau = (f_tau - y) * pow((TAU - alpha) % o.R, o.R - 2, o.R) % o.R
        com, prf = (enc.g1_from_b64(resp.commitment),
                    enc.g1_from_b64(resp.proof))
        check(enc.fr_from_b64(resp.eval_) == y, f"row {i}: eval != f_i(a)")
        check(o.G1.to_affine(com)
              == o.G1.to_affine(o.G1.mul(g, lag[i] * f_tau % o.R)),
              f"row {i}: commitment != [R_i(tau_y) f_i(tau_x)]G1")
        check(o.G1.to_affine(prf)
              == o.G1.to_affine(o.G1.mul(g, lag[i] * q_tau % o.R)),
              f"row {i}: proof != [R_i(tau_y) q_i(tau_x)]G1")
        if i in (0, m - 1):
            check(worker.worker_verify(i, resp.proof, resp.alpha, resp.eval_,
                                       resp.commitment),
                  f"row {i}: worker_verify rejected the proof")
            check(pianist.worker_verify(srs, i, prf, alpha, y, com),
                  f"row {i}: pianist.worker_verify rejected the proof")
        coms.append(com)
        prfs.append(prf)
        ys.append(y)
    say(f"[round] {m} rows through Worker.forward at one alpha: trapdoor "
        f"self-check PASS for each, worker_verify PASS for rows 0 and "
        f"{m - 1}; {sum(times):.2f} s, median "
        f"{statistics.median(times) * 1e3:.2f} ms a row")

    # 4. aggregate and verify
    coms_t, prfs_t = cv.g1_encode(coms, dev), cv.g1_encode(prfs, dev)
    ys_t = FR.encode(ys, dev)
    beta_t = FR.encode([beta], dev)[0]
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg = pianist.aggregate(srs, coms_t, prfs_t, ys_t, beta_t)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    agg_launches = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v - before[k]}
    lag_b = _lagrange_coeffs_at(beta, m)
    check(FR.decode(agg.value)[0]
          == sum(a * b for a, b in zip(lag_b, ys)) % o.R,
          "aggregated value != f(alpha, beta)")
    t0 = time.perf_counter()
    check(pianist.verify_aggregated(srs, agg, alpha, beta),
          "verify_aggregated rejected the aggregated proof")
    t_ver = time.perf_counter() - t0
    forged = dataclasses.replace(agg, value=FR.encode([1], dev)[0])
    check(not pianist.verify_aggregated(srs, forged, alpha, beta),
          "verify_aggregated accepted a changed value")
    bad_ys = ys_t.clone()
    bad_ys[m // 2] = FR.add(ys_t[m // 2], FR.ones((), dev))
    forged = pianist.aggregate(srs, coms_t, prfs_t, bad_ys, beta_t)
    check(not pianist.verify_aggregated(srs, forged, alpha, beta),
          "verify_aggregated accepted a proof with one eval changed")
    say(f"[round] pianist.aggregate: first call {t_agg * 1e3:.2f} ms, "
        f"{sum(agg_launches.values())} kernel launches {agg_launches}; value "
        f"equals f(alpha, beta); verify_aggregated True in "
        f"{t_ver * 1e3:.1f} ms "
        "(host pairing); False with the value changed, and False for the "
        "proof aggregated from one changed eval")

    # 5. launch counts of this path
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        check(v > 0, f"the round path never launched {k}")
    say(f"[round] launches {launches}")

    # after the counts are read: the aggregation warm, on the host's clock
    times = []
    for _ in range(AGGREGATE_WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = pianist.aggregate(srs, coms_t, prfs_t, ys_t, beta_t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(again.proof_y, agg.proof_y)
              and torch.equal(again.value, agg.value),
              "a repeated aggregate gave another proof")
    say(f"[round] pianist.aggregate warm: median "
        f"{statistics.median(times):.2f} ms over {len(times)} "
        f"({', '.join(f'{t:.2f}' for t in times)} ms)")
    return launches


def phase_ntt_cells(dev):
    """Forward + inverse round trips of one transform at 2^16, 2^20, 2^22."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for log_n in NTT_CELL_LOGS:
        x = pianist._uniform_fr(gen, (1 << log_n,))
        check(torch.equal(tntt.intt(tntt.ntt(x)), x),
              f"NTT round trip at 2^{log_n} != identity")
        times = []
        for _ in range(NTT_CELL_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tntt.intt(tntt.ntt(x))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        say(f"[ntt] 2^{log_n} forward + inverse round trip equals the input; "
            f"{NTT_CELL_RUNS} timed runs: median "
            f"{statistics.median(times):.3f} ms, min {min(times):.3f}, max "
            f"{max(times):.3f}")
        del x


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

    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = INT32_LANES_PER_SM * sms * sm_mhz * 1e6
    say(f"[device] bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s; integer rate "
        f"{INT32_LANES_PER_SM} lanes x {sms} SMs x {sm_mhz:.0f} MHz = "
        f"{int_ops_per_s / 1e12:.2f} T 32-bit operations/s")

    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    try:
        res = phase_kernels(rng, dev, int_ops_per_s)
        main_launches = phase_main_path(rng, dev)
        round_launches = phase_round(rng, dev)
        phase_ntt_cells(dev)
        phase_device_times(res, dev)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    say(f"[done] all phases in {time.perf_counter() - t_start:.1f} s after "
        "the build")

    # launches: both paths' counts added, each path counted from 0
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": main_launches[k] + round_launches[k],
              "launches_main": main_launches[k],
              "launches_round": round_launches[k],
              "max_abs_err": res[k]["max_abs_err"],
              "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"],
              "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"],
              "library_ms": None, "device_ms": res[k]["device_ms"],
              "profiler_ms": res[k]["profiler_ms"],
              "other_ms": res[k].get("other_ms")}
             for k, (src, rep) in KERNELS.items()]
    say(json.dumps({"kernels": table}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
