#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``zkp_subnet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. device: the card's name, and ``name, power.limit`` from nvidia-smi;
2. build: the CUDA sources under ``zkp_subnet_tpu_torch/csrc/`` with nvcc
   for sm_90a, one process per source (registers, stack and spills of every
   kernel from ``-Xptxas -v``);
3. kernels vs plain: every kernel on the card against its plain PyTorch
   version on CPU copies of the same inputs, random and edge cases, with
   tolerance zero (integer arithmetic: canonical integers and affine points
   must be equal; the three K2 kernels limb for limb; ``msm_buckets`` also
   on edge cases at the main path's 2^16 points, runs across its tiles and
   one bucket holding a whole row, against the plain version on the card;
   the opening's K3 kernels ``fr_inv`` (also against the oracle, and on
   r − 2 and the aggregation's differences), ``fr_power_tables``,
   ``fr_powers``, ``fr_suffix_scan`` and ``fr_open_quotient`` at x = 0, 1,
   r − 1 and random, one row and four at one x, on rows of zeros, of a
   length that is no multiple of the tile, at the scan's tile (a tile less
   one, one past it, a default row of 1024) and of one whose powers take
   three levels of the tables, and the whole opening of one row and of
   four with the host forbidden to wait for the card; the K1 ladder
   ``g1_scalar_mul`` in both of its forms with scalars 0, 1, r − 1, r − 2,
   every 4-bit window 8, a carry through every window and out of the top,
   2^256 − 1 and the point at infinity at 16 points, at a default
   request's 2 x 1024 and at 2^16 points against the plain version limb
   for limb, at 2 x 2048 and 2^19 one form against the other, and as
   points against the loop of K1 launches it replaces;
   the aggregation's fixed-base MSM ``g1_msm_fixed`` and its table
   ``g1_fixed_table`` at 16, 256 and 1024 bases (one at infinity), scalars
   0, 1, r − 1 and random, three MSMs a call, also against the oracle;
   the challenge's row evaluation ``fr_eval_rows`` at x = 0, 1, r − 1 and
   random, on a row of zeros, one row, every length from 1 to 33 (a
   lane's Horner run of one step, then two), one past a warp's run, 1024,
   1025, 3000, a tile less one, one tile, one past it, and more than 32
   tiles (the second pass's Horner steps), one row at 16 points, and 16 x
   2^16 at one point with the host forbidden to wait for the card);
   then each kernel's time beside its plain version's, both on the card, at
   the shapes the paths below give it (CUDA events around a loop of
   launches: for a short kernel that is the host's cost a launch) and the
   least time the card could take for the same work (``bound_ms``); the
   ladder also at 16 points, 2 x 1024, 2 x 2048 and 2^19, each form at 2 x
   1024, beside K2's ``msm_many`` and the naive MSM (one ladder, one tree)
   of two MSMs at 1024 and 2048 points; for
   K2, the depth of the dependency chain and ms ÷ depth, and
   ``msm_buckets`` on scalars that are all 1 beside uniform ones; the
   aggregation's two MSMs at 16, 256 and 1024 bases by ``g1_msm_fixed``
   beside K2's ``msm_many`` and beside the ladder and tree they replace,
   and its table at 256 and 1024 bases, with the chains of both kernels
   in µs a dependent point operation; the
   opening's kernels also at the [mesh] batch, 256 rows of 2^16 at one
   point (held to the plain versions on four of the rows), and the whole
   opening at one row and at the batch; the scan also at a default row of
   1024; ``fr_eval_rows`` also at [cli]'s challenge, 256 rows of 2^16 at
   one point, and at one 2^16 row at 16 points;
4. ``[main]``, the worker's path: a 2^16-base SRS slice [τ^j]G1 built on the
   card, a ``Worker`` over it, and three 2^16-coefficient ``Prove`` requests
   (two with a challenge point, one commit-only), each checked by the
   trapdoor τ and the pairing verify, with kernel launch counts (one launch
   of each K2 kernel a request: the commit's and the opening's MSMs run as
   one batched MSM; the opening in five K3 launches, at most seven
   K3-family launches and no ``fr_add`` a request; the slice's setup one ladder
   launch and no K1 double); then the median of warm commit+open requests and the
   peak device memory; then skewed rows, as Pianist wire polynomials are
   (three of 90% zeros and ones, one of all ones), each checked the same
   way, and their median; then the host split of a warm request (each step
   of ``Worker.forward`` timed alone, median of 5, beside its total);
5. ``[round]``, the coordinator's side of one Pianist round at the row width
   of the reference mainnet (2^16 coefficients a worker) with 16 workers
   (scale 20, machines_scale 4; mainnet has 256 workers, and the other 240
   rows would repeat the same work): ``Srs.generate`` with a known trapdoor
   (oracle samples, a scalar-multiplication cross-check and every point on
   the curve), a 16 × 2^16 challenge in evaluation form brought to
   coefficient rows by the inverse NTT, every row through
   ``Worker.forward`` at one α, ``pianist.aggregate`` at a β (its launch
   count, and its warm time after the path's counts are read) and
   ``pianist.verify_aggregated`` (True, and False after tampering; the
   aggregation launches ``fr_inv`` once, ``g1_msm_fixed`` once for both
   MSMs and never the ladder, the table once per SRS, and the path no K1
   double); then the coordinator's own round on the same SRS
   (``Coordinator.generate_challenge`` by one ``fr_eval_rows`` and no
   ``fr_inv``, ``run_round`` through ``LocalTransport``, through
   ``HttpTransport`` to a ``WorkerServer`` on 127.0.0.1 and through
   ``MockTransport`` with one corrupt uid, ``aggregate_responses``, the
   weights and ``state.npz``); after the path's counts are read, one
   aggregation at machines_scale 10 (``Srs.generate(16, 10)``: 1024
   workers of 2^6 coefficients, proved by ``commit_all``/``open_all``)
   through ``pianist.aggregate``, ``verify_aggregated`` True and False for
   a tampered proof;
6. ``[ntt]``: forward + inverse round trips at 2^16, 2^20 and 2^22;
7. ``[cli]``, the user's commands (``python -m zkp_subnet_tpu_torch``) in a
   temporary directory: at the reference mainnet deployment (scale 24,
   machines_scale 8: 256 workers x 2^16) ``setup`` (the streaming
   ``Srs.generate_to_disk`` and its sha256 manifest), ``check`` (every line
   PASS), ``aggregate`` over all 256 rows (every reward > 0, every
   response with its proof, the aggregated proof verifies; the split of
   its time, the largest ``process_time``, the peak device memory) and
   ``check`` once a byte of the sidecar is flipped (exit code 1); then at
   scale 20 / machines_scale 4 ``run`` twice on one state directory (the
   second resumes where the first ended), ``serve`` in a thread with a
   ``SubnetClient`` over HTTP (commit and open of a row, the trapdoor
   self-check, verify), and ``localnet`` as a process of its own over two
   ``serve`` processes. The commands run through the CLI's ``main`` in
   this process, so their launches are counted, but ``localnet``. The SRS
   files of both shapes stay for [mesh] (the flipped byte set back);
8. ``[default]``, the configuration a user gets with no flags (scale 18,
   machines_scale 8: 256 workers x 1024 coefficients, the defaults of
   ``runtime/config.py``, the CLI and ``parallel.launch``), no cut:
   ``setup`` and ``check`` with the CLI's defaults (./setup.npz and
   ./precompute.npz in a directory of their own, every line PASS), a
   ``Worker`` over one of the slices serving six commit+open requests and
   a commit-only one (the trapdoor self-check and the pairing verify; one
   ladder launch of the group form, one tree of at most 10 ``g1_add`` and
   no K2 kernel a request; the warm median and the host split), then
   ``parallel.launch.main`` with the launcher's defaults over those files
   as one NCCL rank, two rounds (the split, rows/s, peak memory; a prove's
   local commit+open one ladder over 2^19 products and at most 10
   ``g1_add``; the aggregated proof verifies, a tampered copy not; eight
   sampled workers as in [mesh]);
9. ``[mesh]``, the multi-device path (``zkp_subnet_tpu_torch.parallel``) as
   one NCCL rank (the machine has one card): ``parallel.launch.main`` at
   the mainnet deployment over the 24/8 files [cli] wrote, two rounds, each
   split into the draws, the X inverse NTT of 256 x 2^16, the local
   commit+open of 256 rows, the gather and the aggregation (rows/s, peak
   device memory, the backend, which must be NCCL; the launches: one
   ``fr_inv`` and one ``g1_msm_fixed`` a prove, none of the ladder, the
   table once, in ``shard_srs``; the local commit+open of 256 rows one
   launch of each opening kernel); the last round's
   aggregated proof verifies (and not once tampered), eight sampled
   workers pass ``worker_verify`` and the trapdoor self-check and equal
   ``pianist.worker_commit``/``worker_open`` limb for limb, and
   ``fft(left=False)`` forward then inverse gives the block back; then at
   the [round] shape over [cli]'s 20/4 files ``Coordinator.run`` over
   ``MeshTransport`` for two rounds (every reward > 0, one
   ``process_time`` a round) and a round with one corrupt uid (exactly one
   0); then ``dryrun_multichip(1)``;
10. ``[device]``: each kernel's device time with no host work between
   launches (``device_ms``: CUDA events around the replay of a CUDA graph of
   many launches) and torch.profiler's figure beside it; last, because
   graph captures and a profiler run slow every later launch on the
   host.

The launch counts are set to 0 just before each of the five paths
(``[main]``, ``[round]``, ``[cli]``, ``[default]``, ``[mesh]``) and read
just after it.
The last lines are the kernel table as JSON, the nvidia-smi line and ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the repository beside
it, the script exits non-zero before printing a result.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import inspect
import io
import json
import logging
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from zkp_subnet_tpu_torch import __main__ as cli
from zkp_subnet_tpu_torch import runtime as trt
from zkp_subnet_tpu_torch.api import SubnetClient
from zkp_subnet_tpu_torch.models import pianist
from zkp_subnet_tpu_torch.models.srs import (Srs, _lagrange_coeffs_at,
                                             _trapdoor, default_paths)
from zkp_subnet_tpu_torch.ops import curve as cv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.ops import msm as tmsm
from zkp_subnet_tpu_torch.ops import ntt as tntt
from zkp_subnet_tpu_torch.ops import poly as tpoly
from zkp_subnet_tpu_torch.ops.field import (FQ, FR, almost_inverse,
                                            fq_add_plain, fq_mul_plain,
                                            fq_sub_plain, fr_add_plain,
                                            fr_inv_plain, fr_mul_plain,
                                            fr_power_tables_plain,
                                            fr_powers_plain, fr_sub_plain)
from zkp_subnet_tpu_torch.parallel import launch
from zkp_subnet_tpu_torch.parallel import pianist as par
from zkp_subnet_tpu_torch.parallel.dryrun import dryrun_multichip
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
# the aggregation past 512 workers: scale 16, machines_scale 10 -> 1024
# workers x 2^6 (the keys' count a machines_scale 10 deployment has; the
# rows cut to 64 coefficients)
WIDE_SCALE, WIDE_MACHINES_SCALE = 16, 10
# the aggregation's keys at the widest shape timed here
WIDE_KEYS = 1 << WIDE_MACHINES_SCALE
# the coordinator's rounds on the [round] SRS: the scoring timeout (s)
COORDINATOR_TIMEOUT = 30.0
# [cli]: the reference mainnet deployment (scale 24, machines_scale 8:
# 256 workers x 2^16, bench.py:3-8) through setup, check and aggregate, and
# the [round] shape through run, serve and localnet
CLI_FULL = (24, 8)
CLI_SMALL = (20, 4)
# aggregate's --timeout at full size: LocalTransport hands all 256 rows to
# the executor at once and asyncio.wait_for counts a row's wait in its
# queue against the timeout (runtime/transport.py); mainnet gives each row
# a machine of its own, here they share one card and one host, so the
# round passes a timeout that covers the queue on a slower host too (the
# default stays 30 s; on the H100's host the last row ends ~6 s in)
CLI_FULL_TIMEOUT = 600.0
# the disk the full-size files need beyond the sidecars: setup and
# precompute files, the state, slack
CLI_DISK_SLACK = 1 << 30
# kernels the [cli] and [mesh] paths need not run: the double runs inside
# the ladder, K4 only in this script's on-curve check, and the ladder only
# in naive MSMs, rows of at most 2048 ([default]'s; theirs are 2^12 and
# more, and the aggregation's MSMs are g1_msm_fixed's)
CLI_IDLE = ("g1_double", "fq_mul", "fq_add", "fq_sub", "g1_scalar_mul")
# [default]: the runtime's default configuration (runtime/config.py, the
# CLI's setup and parallel.launch: scale 18, machines_scale 8 -> 256
# workers x 1024 coefficients), no cut; the worker slice its requests go to
DEFAULT_SHAPE = (18, 8)
DEFAULT_WORKER = 7
# [mesh]: rounds of parallel.launch at the mainnet deployment, and the
# workers of the last one held to the pairing, the trapdoor and the
# single-worker path
MESH_ROUNDS = 2
MESH_SAMPLED = 8

# the card's peaks for ``bound_ms``: device memory rate from NVIDIA's data
# sheet (H100 SXM); the integer rate is 64 INT32 lanes per SM (Hopper
# architecture white paper) x the SM count x the card's top SM clock as
# nvidia-smi reports it in this run, one 32x32->64 multiply-add counted as
# one lane-operation
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64

# 32-bit integer operations that each function needs: a CIOS product of L
# limbs is 2·L·L multiply-adds (csrc/mont.cuh); a square L·(L+1)/2 limb
# products (the off-diagonal ones once) and the reduction's L·L
# (mont::sqr); an add or subtract is a carry chain and a conditional
# correction, 2·L. The RCB15 point add (csrc/g1.cuh) is 14 Fq products and
# 19 add/subtracts, the double 9 and 9; of the products 2 and 1 are by the
# constant b3 = 12, which needs no product but 4 additions (2x, 4x, 8x,
# 8x + 4x), and 2 of the double's are squares (Y², Z²). The bound counts
# them so, although the kernels spend a full product on each product by
# b3: 12 products and 27 add/subtracts an add, 6 products, 2 squares and
# 13 add/subtracts a double
OPS_FR_MUL, OPS_FR_LIN = 2 * 8 * 8, 2 * 8
OPS_FQ_MUL, OPS_FQ_LIN = 2 * 12 * 12, 2 * 12
OPS_FQ_SQR = 12 * 13 // 2 + 12 * 12
OPS_G1_ADD = 12 * OPS_FQ_MUL + 27 * OPS_FQ_LIN
OPS_G1_DOUBLE = 6 * OPS_FQ_MUL + 2 * OPS_FQ_SQR + 13 * OPS_FQ_LIN
G1_BYTES, FQ_BYTES, FR_BYTES = 144, 48, 32
# a step of fr_inv's binary inverse: a compare-and-subtract, a cofactor
# add and the shifts of two 8-word values, four carry chains' worth
OPS_INV_STEP = 4 * OPS_FR_LIN
# the K3 kernels of one opening, and K3's elementwise ones
K3_FAMILY = ("fr_mul", "fr_add", "fr_sub", "fr_inv", "fr_power_tables",
             "fr_powers", "fr_suffix_scan", "fr_open_quotient",
             "fr_eval_rows")
# the opening's kernels after the inverse, one launch each for any rows at
# one point
OPENING = ("fr_power_tables", "fr_powers", "fr_suffix_scan",
           "fr_open_quotient")
# [mesh]'s opening: the rows a prove opens at one point (256 workers of
# 2^16 at 24/8), and the rows of that batch held to the plain versions
MESH_BATCH = 256
BATCH_SAMPLED = (0, 1, 128, 255)
# a row length whose powers take three levels of the tables (> 2^16)
THREE_LEVELS = 70000
LADDER_BITS = 256
# the double's sizes held to its plain version: every boundary of a warp
# (32 points) and a block (128 points) of its kernel, and past one wave of
# the card
DOUBLE_SIZES = (1, 2, 3, 31, 32, 33, 127, 128, 129, (1 << 16) + 3)
# the ladder's scalars beside 0, 1, r − 1 and random ones: r − 2, every
# 4-bit window 8, a carry through every window and out of the top
# (0x88…89), 2^256 − 1
LADDER_EDGES = (o.R - 2, int("8" * 64, 16), int("8" * 64, 16) + 1,
                (1 << 256) - 1)
# the group form's chain a point: the table's 7 operations, 63 windows of
# 4 doubles, an add a window
LADDER_DEPTH = 7 + 4 * 63 + 64
# the kernels that time far above the rest at the path's shape: the plain
# version runs once (no warm-up call) and the kernel a few times
SLOW_PLAIN = ("g1_scalar_mul", "g1_fixed_table")

_PALLAS = "zkp_subnet_tpu/ops/pallas_g1.py"

_CSRC = "zkp_subnet_tpu_torch/csrc/"

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "g1_add": (_CSRC + "g1.cu", _PALLAS + ":181"),
    "g1_double": (_CSRC + "g1.cu", _PALLAS + ":181"),
    # pfield over lazy8.ZFQ via dispatch_ldouble/dispatch_ladd, as
    # curve.g1_scalar_mul reaches it
    "g1_scalar_mul": (_CSRC + "g1.cu", _PALLAS + ":181"),
    # the same, as the naive MSM of the aggregation (msm.py:msm_auto)
    # reaches it: the table once per SRS, then the windowed MSMs
    "g1_fixed_table": (_CSRC + "g1.cu", _PALLAS + ":181"),
    "g1_msm_fixed": (_CSRC + "g1.cu", _PALLAS + ":181"),
    "msm_buckets": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:202"),
    "msm_reduce": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:303"),
    "msm_combine": (_CSRC + "msm.cu", "zkp_subnet_tpu/ops/msm.py:384"),
    "fr_mul": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_add": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_sub": (_CSRC + "fr.cu", _PALLAS + ":181"),
    # pfield over lane8.BFR as field.pow_static/powers and poly._fmul/_fadd
    # reach it
    "fr_inv": (_CSRC + "fr.cu", _PALLAS + ":181"),
    # the tables of powers of the opening's point and of its inverse, the
    # chain of squarings the two kernels after it ran in every block before
    "fr_power_tables": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_powers": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_suffix_scan": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fr_open_quotient": (_CSRC + "fr.cu", _PALLAS + ":181"),
    # pfield over lane8.BFR as poly._fmul/_tree_sum_lane reach it from
    # poly_eval under the coordinator's jax.vmap (coordinator.py:91)
    "fr_eval_rows": (_CSRC + "fr.cu", _PALLAS + ":181"),
    "fq_mul": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fq_add": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fq_sub": (_CSRC + "fq.cu", _PALLAS + ":181"),
    "fr_butterfly": (_CSRC + "ntt.cu", _PALLAS + ":219"),
}


# the kernel function each wrapper launches, as kernels.ptxas_usage keys
# nvcc's register report (K3/K4: the instantiation of the Op it launches,
# MUL = 0, ADD = 1, SUB = 2 in csrc/fr.cu and csrc/fq.cu)
KERNEL_FUNCTIONS = {
    "g1_add": "g1_add_kernel", "g1_double": "g1_double_kernel",
    "g1_scalar_mul": "g1_scalar_mul_kernel",
    "g1_fixed_table": "g1_fixed_table_kernel",
    "g1_msm_fixed": "g1_msm_fixed_kernel", "fr_inv": "fr_inv_kernel",
    "fr_power_tables": "fr_power_tables_kernel",
    "fr_powers": "fr_powers_kernel", "fr_suffix_scan": "fr_suffix_scan_kernel",
    "fr_open_quotient": "fr_open_quotient_kernel",
    "fr_eval_rows": "fr_eval_partial_kernel",
    "msm_buckets": "msm_buckets_kernel", "msm_reduce": "msm_reduce_kernel",
    "msm_combine": "msm_combine_kernel", "fr_mul": "fr_binary_kernel<0>",
    "fr_add": "fr_binary_kernel<1>", "fr_sub": "fr_binary_kernel<2>",
    "fq_mul": "fq_binary_kernel<0>", "fq_add": "fq_binary_kernel<1>",
    "fq_sub": "fq_binary_kernel<2>", "fr_butterfly": "fr_butterfly_kernel"}


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
    edges = [0, 1, F.p - 1, F.p - 2][:n]
    vals[:len(edges)] = edges
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


def byte_limbs(values: np.ndarray) -> np.ndarray:
    """(n, 16) uint32 16-bit limbs of scalars whose 32 bytes all equal
    values[i] (so every 8-bit window's digit is values[i])."""
    v = values.astype(np.uint32)[:, None]
    return np.repeat(v | v << 8, 16, axis=1)


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


def same_fr_pair(got, want) -> int:
    """same_fr over two tuples of tensors (the scan passes' two outputs)."""
    return max(same_fr(g, w) for g, w in zip(got, want, strict=True))


def shape_of(out):
    return (tuple(tuple(t.shape) for t in out) if isinstance(out, tuple)
            else tuple(out.shape))


def time_cuda(fn, reps, warm=True):
    """(mean ms per call over ``reps`` calls after one warm-up call, the
    warm-up call's result), timed with CUDA events. ``warm=False``: no
    warm-up call; the result is the first timed call's."""
    out = fn() if warm else None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        last = fn()
        out = last if out is None else out
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
    p20 = p.repeat(16, 1, 1)                       # the double at 2^20
    a, b = random_fr(rng, n, dev), random_fr(rng, n, dev)
    # two MSMs over the same bases, as one request's commit and opening
    sc = FR.from_limbs16(random_scalar_limbs(rng, 2 * n).reshape(2, n, 16),
                         dev)
    runs = tmsm.bucket_runs(sc, tmsm._groups(n))
    runs1 = tmsm.bucket_runs(sc[0], tmsm._groups(n))
    ones = np.zeros((2, n, 16), np.uint32)
    ones[..., 0] = 1
    runs_ones = tmsm.bucket_runs(FR.from_limbs16(ones, dev), tmsm._groups(n))
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
    # one opening at 2^16 (x random, its inverse, the tables of both, the
    # first pass's output), and the ladders of build_srs (2^16 points) and
    # of the aggregation's naive MSMs (16), with scalars 0, 1, r - 1 and
    # the point at infinity in the first rows
    x1 = random_fr(rng, 5, dev)[4].contiguous()
    xi1 = kernels.fr_inv(x1)
    tab1 = kernels.fr_power_tables(x1, n, xi1)
    local, totals = kernels.fr_suffix_scan(a)
    # [mesh]'s batch: 256 rows of 2^16 at x1, each row a times its own
    # factor, and the first pass over them laid end to end
    batch = kernels.fr_mul(
        a.repeat(MESH_BATCH, 1),
        random_fr(rng, MESH_BATCH, dev).repeat_interleave(n, 0)).view(
            MESH_BATCH, n, 8)
    blocal, btotals = tpoly._scan_on_card(batch)
    lp = p.clone()
    lp[3] = cv.g1_infinity((), dev)
    ls = FR.from_limbs16(random_scalar_limbs(rng, n), dev)
    ls[:3] = cv.fr_to_scalar_limbs([0, 1, o.R - 1], dev)
    # the ladder at a default request (two MSMs over one row of 1024
    # bases, which msm_auto_many repeats), at the most a naive MSM takes
    # (2 x 2048) and at a default one-rank prove (2^19 products)
    lsp = FR.from_limbs16(random_scalar_limbs(rng, 1 << 19), dev)
    # the aggregation's Lagrange-Y MSMs (C_y and W_y) at the mainnet shape
    # of [cli] and [mesh], 256 keys (Z != 1, one at infinity), at [round]'s
    # 16 and at machines_scale 10's 1024: the keys' window table (a key's
    # rows depend on that key alone, so the first keys' rows are the table
    # of those keys) and two MSMs' scalars
    lag1k = random_points(rng, WIDE_KEYS, dev)[0]
    lag1k[3] = cv.g1_infinity((), dev)
    tab1k = kernels.g1_fixed_table(lag1k)
    lag, tab = lag1k[:256].contiguous(), tab1k[:256].contiguous()
    fsc1k = FR.from_limbs16(random_scalar_limbs(rng, 2 * WIDE_KEYS).reshape(
        2, WIDE_KEYS, 16), dev)
    fsc = fsc1k[:, :256].contiguous()
    # the coordinator's challenge: m rows of 2^16 coefficients at one alpha
    # ([cli]'s 256 rows: the batch); poly_eval_many's one row at 16 points
    rows = fr_from_canonical_limbs(
        random_scalar_limbs(rng, m * n).reshape(m, n, 16), dev)
    return types.SimpleNamespace(rows=rows, alpha=x1.view(1, 8),
                                 pts16=random_fr(rng, m, dev),
                                 n=n, m=m, n_srs=n_srs, p=p, p20=p20, q=q,
                                 a=a, b=b,
                                 sa=sa, sb=sb, qa=qa, qb=qb, runs=runs,
                                 runs1=runs1, runs_ones=runs_ones, bk=bk,
                                 wins=wins, x1=x1, xi1=xi1, tab1=tab1,
                                 local=local, totals=totals, batch=batch,
                                 blocal=blocal, btotals=btotals, lp=lp,
                                 ls=ls,
                                 lp16=lp[:16].contiguous(),
                                 ls16=ls[:16].contiguous(),
                                 lp2k=lp[:1024].repeat(2, 1, 1),
                                 ls2k=lsp[:2048].contiguous(),
                                 lp4k=lp[:2048].repeat(2, 1, 1),
                                 ls4k=lsp[:4096].contiguous(),
                                 lp512k=lp.repeat(8, 1, 1), ls512k=lsp,
                                 diffs=FR.sub(x1, aggregation_dom(m, dev)),
                                 lag=lag, tab=tab, fsc=fsc, lag1k=lag1k,
                                 tab1k=tab1k, fsc1k=fsc1k,
                                 lag16=lag[:m].contiguous(),
                                 tab16=tab[:m].contiguous(),
                                 fsc16=fsc[:, :m].contiguous())


#: the label of the path fr_eval_rows replaced in ``other_ms``
OPENINGS = "16 rows by 16 openings, y kept (the path before)"


def openings_y(rows, alpha):
    """The rows at alpha as ``poly_eval`` took them before ``fr_eval_rows``:
    one opening a row (five K3 launches), the quotient dropped."""
    return torch.stack([tpoly._open_on_card(r, alpha[0])[0] for r in rows])


def aggregation_dom(m, dev):
    """The domain points ω^i of ``pianist.aggregate`` for m workers."""
    return pianist.aggregation_constants(m, dev)[0]


def scalar_mul_ops(scalars: torch.Tensor) -> int:
    """Integer operations that [k_i]P_i needs at the least for this run's
    (N, 8) scalars, whatever the method: bitlen(k) − 1 doublings, and the
    adds of the best fixed window of w ≤ 8 bits for each k, 2^(w−1) − 1
    for the odd multiples and one a nonzero window but the first (w = 1 is
    the ladder's binary method, ~128 adds a random k; w = 5 needs ~65)."""
    n = scalars.shape[0]
    bits = np.unpackbits(scalars.cpu().numpy().view(np.uint8),
                         bitorder="little").reshape(n, 256).astype(bool)
    top = 256 - np.argmax(bits[:, ::-1], axis=1)
    bitlen = np.where(bits.any(1), top, 0)
    adds = np.full(n, 1 << 30, np.int64)
    for w in range(1, 9):
        width = -(-256 // w) * w
        padded = np.zeros((n, width), bool)
        padded[:, :256] = bits
        nonzero = padded.reshape(n, -1, w).any(2).sum(1)
        adds = np.minimum(adds, (1 << (w - 1)) - 1
                          + np.maximum(nonzero - 1, 0))
    return (OPS_G1_DOUBLE * int(np.maximum(bitlen - 1, 0).sum())
            + OPS_G1_ADD * int(adds.sum()))


def ladder_by_launches(p, scalars):
    """The ladder as the port ran it before it was one kernel: for each of
    the 256 bits one K1 double, one K1 add and a select."""
    acc = cv.g1_infinity(p.shape[:-2], p.device)
    for bit in range(LADDER_BITS - 1, -1, -1):
        b = (scalars[..., bit // 32] >> (bit % 32)) & 1
        acc = kernels.g1_double(acc)
        acc = cv.g1_select(b.bool(), kernels.g1_add(acc, p), acc)
    return acc


def bucket_add_count(digits: torch.Tensor) -> int:
    """Point adds that sorted digit rows need: every entry of digit ≠ 0
    but the first of its bucket."""
    nz = digits != 0
    first = torch.ones_like(nz)
    first[:, 1:] = digits[:, 1:] != digits[:, :-1]
    return int(nz.sum()) - int((nz & first).sum())


def inverse_steps(t: torch.Tensor) -> list:
    """Steps of fr_inv's binary inverse on each element (none for 0)."""
    return [almost_inverse(a)[2] if a else 0 for a in FR.limbs_to_ints(t)]


def inverse_ops(t: torch.Tensor) -> int:
    """Integer operations of fr_inv on these elements: each nonzero one's
    steps (this run's data) and the two closing Montgomery products."""
    return sum(n * OPS_INV_STEP + 2 * OPS_FR_MUL for n in inverse_steps(t)
               if n)


def fixed_msm_ops(scalars: torch.Tensor) -> int:
    """Integer operations that K MSMs over a fixed-base window table need on
    these (K, M, 8) canonical scalars, the table given (the bound): no
    doubles, by buckets over the byte digits. An MSM adds each nonzero term
    into its digit's bucket (a copy the first of a bucket), then sums the
    buckets from its top digit t down (a running sum, an add a nonempty
    bucket but the first, and t − 1 adds of it to the total): nonzero terms
    + t − 2 adds."""
    d = scalars.cpu().numpy().view(np.uint8).reshape(scalars.shape[0], -1)
    nz = (d != 0).sum(1)
    top = d.max(1).astype(np.int64)
    return OPS_G1_ADD * int(np.where(nz > 0, nz + top - 2, 0).sum())


def fixed_kernel_ops(scalars: torch.Tensor) -> int:
    """Integer operations of g1_msm_fixed's own method on these (K, M, 8)
    scalars (for comparison with the bound): each MSM sums its 64·M
    signed-digit terms, zero digits' infinities included, by a tree: 64·M −
    1 adds an MSM, no doubles (the negations, one Fq subtract a negative
    digit, counted too)."""
    k, m = scalars.shape[:2]
    negative = int((tmsm.fixed_digits_plain(scalars.cpu()) < 0).sum())
    return (OPS_G1_ADD * k * (tmsm.FIXED_WINDOWS * m - 1)
            + OPS_FQ_LIN * negative)


def fixed_depth(m: int) -> int:
    """Longest chain of dependent point adds in g1_msm_fixed at m bases:
    each launch of its tree adds as many levels as its fullest block's
    inputs need (log2 of 32, or fewer in a lone short block)."""
    return sum((min(n, tmsm.FIXED_FAN_IN) - 1).bit_length()
               for n in kernels.fixed_passes(m)[:-1])


#: the table's doubles a key, in a row (split over the lanes), and its
#: longest chain of dependent point operations: those, then one add
TABLE_DOUBLES = tmsm.FIXED_DIGIT_BITS * tmsm.FIXED_WINDOWS - 1
TABLE_DEPTH = TABLE_DOUBLES + 1


def fixed_table_need(keys: torch.Tensor):
    """(bytes, operations) of the table that ``fixed_msm_need``'s bound
    reads, from these (M, 3, 12) keys: each key's 32 window bases
    [256^w]P of 8 bits, the keys read and the bases written once; 248
    doubles a key not at infinity, each base 8 doubles from the one
    below (the bound of table and MSM together is then one design's)."""
    finite = int((keys[:, 2] != 0).any(-1).sum())
    return (G1_BYTES * keys.shape[0] * (1 + tmsm.NUM_WINDOWS),
            finite * OPS_G1_DOUBLE * tmsm.WINDOW_BITS
            * (tmsm.NUM_WINDOWS - 1))


def fixed_msm_need(m, scalars):
    """(bytes, operations) of the bound of K MSMs over m fixed keys:
    buckets over the keys' 8-bit window table (``fixed_msm_ops``), that
    table read once, the scalars read and the sums written once."""
    return (G1_BYTES * m * tmsm.NUM_WINDOWS + 4 * scalars.numel()
            + G1_BYTES * scalars.shape[0], fixed_msm_ops(scalars))


def aggregation_msms_before(points, scalars):
    """The aggregation's MSMs as the port ran them before g1_msm_fixed: for
    each, one ladder launch (a thread a point) and a g1_sum tree of
    g1_add launches (msm.msm_naive)."""
    return torch.stack([tmsm.msm_naive(points, s) for s in scalars])


def powers_need(rows, n):
    """(bytes, operations) that x^k·c_{b,k} over rows × n needs: c read and
    out written once; x^k by one product from x^(k−1) (once for all
    rows), then one by c_{b,k}."""
    return (FR_BYTES * (2 * rows * n + 1),
            (rows * n + n - 1) * OPS_FR_MUL)


def quotient_need(rows, n):
    """(bytes, operations) of the quotient pass over rows × n at one x:
    local read and q written once (and the tiles' totals, x, 1/x, y); an
    add and a product an element, the powers of 1/x once for all rows, and
    the adds of the tiles' carries."""
    tiles = -(-n // tpoly.SCAN_TILE)
    return (FR_BYTES * (rows * (2 * n + tiles + 1) + 2),
            rows * n * (OPS_FR_LIN + OPS_FR_MUL) + (n - 2) * OPS_FR_MUL
            + rows * tiles * OPS_FR_LIN)


def eval_need(rows, n, coeff_rows, points):
    """(bytes, operations) of y_r = Σ_k c_{r,k}·x_r^k for rows × n from
    coeff_rows rows of coefficients (rows, or one for every point) and
    points points: the coefficients and the points read and y written once;
    Horner's one product and one add an element, the least any method
    needs."""
    return (FR_BYTES * (coeff_rows * n + points + rows),
            rows * n * (OPS_FR_MUL + OPS_FR_LIN))


def scan_need(rows, n):
    """(bytes, operations) of the scan's first pass over rows × n: terms
    read, local sums written once, the tiles' totals; an add an element."""
    tiles = -(-n // tpoly.SCAN_TILE)
    return (FR_BYTES * rows * (2 * n + tiles),
            rows * (n - 1) * OPS_FR_LIN)


def path_calls(x):
    """{kernel: (kernel call, plain call, repetitions, comparison, bytes
    moved (each input read once, each output written once), integer
    operations)} over ``path_inputs``; K5 is ``time_butterfly``'s."""
    n, m, n_srs = x.n, x.m, x.n_srs
    p, q, a, b, sa, sb, qa, qb = x.p, x.q, x.a, x.b, x.sa, x.sb, x.qa, x.qb
    runs, bk, wins = x.runs, x.bk, x.wins
    pts, limbs, fr, fq = same_points, same_limbs, same_fr, same_fq
    rows_b, nb = bk.shape[:2]
    bucket_adds = bucket_add_count(runs[1])        # this run's data
    windows = tmsm.NUM_WINDOWS
    x1, xi1, tab1, local, totals, lp, ls = x.x1, x.xi1, x.tab1, x.local, \
        x.totals, x.lp, x.ls
    return {
        "g1_scalar_mul": (lambda: kernels.g1_scalar_mul(lp, ls),
                          lambda: cv.g1_scalar_mul_plain(lp, ls), 3, limbs,
                          2 * G1_BYTES * n + FR_BYTES * n,
                          scalar_mul_ops(ls)),
        "fr_inv": (lambda: kernels.fr_inv(x1), lambda: fr_inv_plain(x1), 20,
                   fr, 2 * FR_BYTES, inverse_ops(x1)),
        # the aggregation's table (once per SRS) and its two MSMs at 256
        # keys; the table's bound counts the doubles of the finite keys
        "g1_fixed_table": (
            lambda: kernels.g1_fixed_table(x.lag),
            lambda: tmsm.fixed_table_plain(x.lag), 2, limbs,
            *fixed_table_need(x.lag)),
        "g1_msm_fixed": (
            lambda: kernels.g1_msm_fixed(x.tab, x.fsc),
            lambda: tmsm.msm_fixed_plain(x.tab, x.fsc), 10, limbs,
            *fixed_msm_need(x.tab.shape[0], x.fsc)),
        # what the tables hold, each entry one product from another; the
        # kernel's time is its chain of ~9 products a level (latency)
        "fr_power_tables": (
            lambda: kernels.fr_power_tables(x1, n, xi1),
            lambda: fr_power_tables_plain(x1, n, xi1), 50, same_limbs,
            FR_BYTES * (2 + tab1.numel() // 8),
            tab1.numel() // 8 * OPS_FR_MUL),
        "fr_powers": (lambda: kernels.fr_powers(tab1[0], n, a),
                      lambda: fr_powers_plain(tab1[0], n, a), 50, fr,
                      *powers_need(1, n)),
        "fr_suffix_scan": (lambda: kernels.fr_suffix_scan(a),
                           lambda: tpoly.fr_suffix_scan_plain(a), 50,
                           same_fr_pair, *scan_need(1, n)),
        "fr_open_quotient": (
            lambda: kernels.fr_open_quotient(local, totals, x1, tab1[1], a),
            lambda: tpoly.fr_open_quotient_plain(local, totals, x1, tab1[1],
                                                 a),
            50, same_fr_pair, *quotient_need(1, n)),
        "fr_eval_rows": (lambda: kernels.fr_eval_rows(x.rows, x.alpha),
                         lambda: tpoly.fr_eval_rows_plain(x.rows, x.alpha),
                         50, fr, *eval_need(m, n, m, 1)),
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
                        lambda: tmsm.msm_buckets_plain(p, *runs), 5, limbs,
                        G1_BYTES * n + 5 * runs[0].numel()
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
    record("g1_double", same_limbs(kernels.g1_double(p),
                                   cv.g1_double_plain(p.cpu())))
    say(f"[kernels] K1 g1_add / g1_double: {n} points incl. P+P, P+(-P), "
        "inf+P, P+inf, inf+inf: equal to plain")
    # the double at every warp and block boundary of its kernel, the points
    # above (Z != 1, infinity at 2 and 4) repeated; plain on the card
    for m in DOUBLE_SIZES:
        pts = p.repeat(-(-m // n), 1, 1)[:m].contiguous()
        record("g1_double", same_limbs(kernels.g1_double(pts),
                                       cv.g1_double_plain(pts)))
    say("[kernels] K1 g1_double at " + ", ".join(map(str, DOUBLE_SIZES))
        + " points (infinity and Z != 1 among them): equal to plain limb "
        "for limb")

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

    phase_opening_kernels(rng, dev, record)
    phase_eval_rows_kernel(rng, dev, record)

    # the K1 ladder at 16 points: scalars 0, 1, r − 1, r − 2, every 4-bit
    # window 8, a carry through every window and out of the top, 2^256 − 1,
    # the point at infinity, random; in both of its forms against the plain
    # version, limb for limb, and as points against the loop of K1 launches
    # it replaces (the other shapes: at the paths' below)
    lp = cv.g1_double_plain(random_points(rng, 16, "cpu")[0])    # Z ≠ 1
    lp[3] = cv.g1_infinity(())
    ls = FR.from_limbs16(random_scalar_limbs(rng, 16))
    ls[:3] = cv.fr_to_scalar_limbs([0, 1, o.R - 1])
    ls[4:8] = torch.from_numpy(np.frombuffer(b"".join(
        k.to_bytes(32, "little") for k in LADDER_EDGES), "<i4").reshape(
            4, 8).copy())
    want = cv.g1_scalar_mul_plain(lp, ls)
    lp, ls = lp.to(dev), ls.to(dev)
    for grouped in (True, False):
        record("g1_scalar_mul", same_limbs(kernels._ladder(lp, ls, grouped),
                                           want))
    record("g1_scalar_mul", same_points(kernels.g1_scalar_mul(lp, ls),
                                        ladder_by_launches(lp, ls)))
    say("[kernels] K1 g1_scalar_mul: 16 points, scalars 0, 1, r-1, r-2, "
        "every window 8, a carry through every window, 2^256-1 and random, "
        "the point at infinity: both forms equal limb for limb to plain, "
        "and as points to the K1 launch loop")
    phase_fixed_msm_kernels(rng, dev, record)

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
    # order), on random scalars at 4096 points and on edge cases at 512 and
    # 2^16 (the main path's rows: 8 groups of 8192 entries, tiles of 32):
    # buckets against the plain version limb for limb (on CPU copies, at
    # 2^16 on the card); at 4096 and 512 reduce (every row) and combine
    # (K = 2 and K = 1) limb for limb too; then the batched MSM against two
    # single ones and against the oracle via the known dlogs.
    pts, dlogs = random_points(rng, n, dev)
    k = random_scalar_limbs(rng, 1)
    rand512 = random_scalar_limbs(rng, 512)
    big = 1 << LOG_N
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
             ("every point the same", 512, rand512, 0),
             # every digit of point i is (i // 3) % 255 + 1: runs of 3
             # entries across the tiles of 2
             ("runs that cross tile edges", 512, byte_limbs(
                 np.arange(512) // 3 % 255 + 1), None),
             ("one bucket holds a whole row", 512, byte_limbs(
                 np.full(512, 7)), None),
             # runs of 37 across the tiles of 32
             ("runs that cross tile edges", big, byte_limbs(
                 np.arange(big) // 37 % 255 + 1), None),
             ("one bucket holds a whole row", big, byte_limbs(
                 np.full(big, 7)), None)]
    for label, m, limbs, repeat in cases:
        if repeat is not None:
            pp = pts[repeat:repeat + 1].repeat(m, 1, 1)
            logs = [dlogs[repeat]] * m
        else:
            pp = pts[:min(m, n)].repeat(-(-m // n), 1, 1)[:m].contiguous()
            logs = (dlogs * -(-m // n))[:m]
        both = np.stack([limbs, limbs[::-1]])
        sc = FR.from_limbs16(both, dev)                    # (2, m, 8)
        groups = tmsm._groups(m)
        runs = tmsm.bucket_runs(sc, groups)
        bk = kernels.msm_buckets(pp, *runs)
        if m > n:              # the plain version on the card
            record("msm_buckets", same_limbs(
                bk, tmsm.msm_buckets_plain(pp, *runs)))
        else:
            record("msm_buckets", same_limbs(bk, tmsm.msm_buckets_plain(
                pp.cpu(), *(t.cpu() for t in runs))))
            sk = kernels.msm_reduce(bk)
            record("msm_reduce", same_limbs(sk, tmsm.msm_reduce_plain(bk)))
            wins = sk[:2 * tmsm.NUM_WINDOWS].view(2, tmsm.NUM_WINDOWS, 3,
                                                  12)
            wp = tmsm.msm_combine_plain(wins.cpu())
            record("msm_combine", same_limbs(tmsm.msm_combine(wins), wp))
            record("msm_combine", same_limbs(tmsm.msm_combine(wins[1]),
                                             wp[1]))
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
            f"groups, {bk.shape[0]} rows of {runs[0].shape[1]}, tiles of "
            f"{tmsm.bucket_tile(runs[0].shape[1])}): buckets equal to "
            "plain limb for limb"
            + ("" if m > n else "; reduce and combine (K = 2, K = 1) equal "
               "to plain limb for limb")
            + "; msm_many equals two msm calls and the oracle")

    # the paths' shapes: kernel and plain both on the card, timed, and
    # their results compared
    x = path_inputs(rng, dev)
    timings = path_calls(x)
    nb, windows = x.bk.shape[1], tmsm.NUM_WINDOWS
    # the longest chain of dependent point operations in the K2 kernels:
    # what the two chains are bound by, and the walk's bound whatever the
    # digits
    depth = {"msm_buckets": (tmsm.bucket_depth(x.runs[0].shape[1]),
                             "point operations"),
             "msm_reduce": (tmsm.reduce_depth(nb), "point operations"),
             "msm_combine": (windows * (tmsm.WINDOW_BITS + 1),
                             "point operations"),
             "fr_inv": (inverse_steps(x.x1)[0], "binary-inverse steps"),
             # a level's 8-step scan and the next level's base
             "fr_power_tables": (9 * x.tab1.shape[1] - 1, "products"),
             "g1_msm_fixed": (fixed_depth(x.tab.shape[0]),
                              "point adds (each split over 6 lanes)"),
             "g1_fixed_table": (TABLE_DEPTH, "point operations (255 "
                                "doubles split over 4 lanes, then an add)")}
    for name, (kern, plain, reps, same, nbytes, ops) in timings.items():
        r = res[name]
        r["ms"], got = time_cuda(kern, reps)
        r["plain_ms"], want = time_cuda(plain, 1, warm=name not in SLOW_PLAIN)
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, int_ops_per_s)
        record(name, same(got, want))
        del want
        say(f"[kernels] {name} at its path's shape {shape_of(got)}: "
            f"equal to plain; kernel {r['ms']:.4f} ms a launch on the "
            f"host's loop, plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        if name in depth:
            steps, unit = depth[name]
            say(f"[kernels] {name}: longest chain {steps} dependent {unit}, "
                f"{r['ms'] / steps * 1e3:.3f} us each")
    # the ladder against the loop of K1 launches it replaces, at 2^16 points
    record("g1_scalar_mul", same_points(kernels.g1_scalar_mul(x.lp, x.ls),
                                        ladder_by_launches(x.lp, x.ls)))
    say(f"[kernels] g1_scalar_mul at 2^{LOG_N} points (scalars 0, 1, r-1, "
        "the point at infinity, random): equal as points to the loop of "
        f"{2 * LADDER_BITS} K1 launches it replaces")
    # the same kernels at one MSM (the shapes a lone commit gives them)
    p, runs1, bk, wins = x.p, x.runs1, x.bk, x.wins
    ones = x.runs_ones
    bk1 = kernels.msm_buckets(p, *runs1)
    groups = tmsm._groups(x.n)
    limbs = same_limbs
    others = [("msm_buckets", "one MSM", limbs,       # against its rows of
               lambda: kernels.msm_buckets(p, *runs1),    # the batched launch
               lambda: bk.view(groups, 2, windows, nb, 3, 12)[:, 0].reshape(
                   -1, nb, 3, 12)),
              ("msm_buckets", "all-ones scalars", limbs,   # 2 MSMs, every
               lambda: kernels.msm_buckets(p, *ones),      # scalar 1
               lambda: tmsm.msm_buckets_plain(p, *ones)),
              ("msm_reduce", "one MSM", limbs,
               lambda: kernels.msm_reduce(bk1),
               lambda: tmsm.msm_reduce_plain(bk1)),
              ("msm_combine", "one MSM", limbs,
               lambda: kernels.msm_combine(wins[0], 8),
               lambda: tmsm.msm_combine_plain(wins[0])),
              # the ladder at 16 points, a default request's 2 x 1024 (the
              # plain version beside both), 2 x 2048 and a default prove's
              # 2^19 (each form beside the other: the wrapper's pick, then
              # the other form); K2 and the naive MSM at 2 x 1024 and
              # 2 x 2048 (msm_auto_many: the ladder and one tree), as the
              # yardstick; the aggregation's 16 inverses
              ("g1_scalar_mul", "16 points", limbs,
               lambda: kernels.g1_scalar_mul(x.lp16, x.ls16),
               lambda: cv.g1_scalar_mul_plain(x.lp16, x.ls16)),
              ("g1_scalar_mul", "2 x 1024", limbs,
               lambda: kernels.g1_scalar_mul(x.lp2k, x.ls2k),
               lambda: cv.g1_scalar_mul_plain(x.lp2k, x.ls2k)),
              ("g1_scalar_mul", "2 x 1024, the other form", limbs,
               lambda: kernels._ladder(x.lp2k, x.ls2k, not kernels.
                                       ladder_grouped(2048)),
               lambda: kernels.g1_scalar_mul(x.lp2k, x.ls2k)),
              ("g1_scalar_mul", "2 x 2048", limbs,
               lambda: kernels.g1_scalar_mul(x.lp4k, x.ls4k),
               lambda: kernels._ladder(x.lp4k, x.ls4k, not kernels.
                                       ladder_grouped(4096))),
              ("g1_scalar_mul", "2^19 points", limbs,
               lambda: kernels.g1_scalar_mul(x.lp512k, x.ls512k),
               lambda: kernels._ladder(x.lp512k, x.ls512k, not kernels.
                                       ladder_grouped(1 << 19))),
              ("g1_scalar_mul", "msm_auto_many, 2 x 1024", same_points,
               lambda: tmsm.msm_auto_many(x.lp[:1024], x.ls2k.view(2, -1, 8)),
               lambda: tmsm.msm_many(x.lp[:1024], x.ls2k.view(2, -1, 8))),
              ("g1_scalar_mul", "K2 msm_many, 2 x 1024", same_points,
               lambda: tmsm.msm_many(x.lp[:1024], x.ls2k.view(2, -1, 8)),
               lambda: tmsm.msm_auto_many(x.lp[:1024], x.ls2k.view(2, -1, 8))),
              ("g1_scalar_mul", "msm_auto_many, 2 x 2048", same_points,
               lambda: tmsm.msm_auto_many(x.lp[:2048], x.ls4k.view(2, -1, 8)),
               lambda: tmsm.msm_many(x.lp[:2048], x.ls4k.view(2, -1, 8))),
              ("g1_scalar_mul", "K2 msm_many, 2 x 2048", same_points,
               lambda: tmsm.msm_many(x.lp[:2048], x.ls4k.view(2, -1, 8)),
               lambda: tmsm.msm_auto_many(x.lp[:2048], x.ls4k.view(2, -1, 8))),
              ("fr_inv", "16 elements", same_fr,
               lambda: kernels.fr_inv(x.diffs),
               lambda: fr_inv_plain(x.diffs)),
              # the aggregation's two MSMs at [round]'s 16 keys and at
              # machines_scale 10's 1024 (and the table of those); and at
              # 1024, 256 and 16 the yardsticks: K2's batched Pippenger, and
              # the ladder and tree of the aggregation before g1_msm_fixed
              ("g1_msm_fixed", "16 keys, 2 MSMs", limbs,
               lambda: kernels.g1_msm_fixed(x.tab16, x.fsc16),
               lambda: tmsm.msm_fixed_plain(x.tab16, x.fsc16)),
              ("g1_msm_fixed", "1024 keys, 2 MSMs", limbs,
               lambda: kernels.g1_msm_fixed(x.tab1k, x.fsc1k),
               lambda: tmsm.msm_fixed_plain(x.tab1k, x.fsc1k)),
              ("g1_fixed_table", "1024 keys", limbs,
               lambda: kernels.g1_fixed_table(x.lag1k),
               lambda: tmsm.fixed_table_plain(x.lag1k)),
              ("g1_msm_fixed", "K2 msm_many, 1024 keys, 2 MSMs", same_points,
               lambda: tmsm.msm_many(x.lag1k, x.fsc1k),
               lambda: kernels.g1_msm_fixed(x.tab1k, x.fsc1k)),
              ("g1_msm_fixed", "ladder + g1_sum (before), 1024 keys, 2 MSMs",
               same_points, lambda: aggregation_msms_before(x.lag1k, x.fsc1k),
               lambda: kernels.g1_msm_fixed(x.tab1k, x.fsc1k)),
              ("g1_msm_fixed", "K2 msm_many, 256 keys, 2 MSMs", same_points,
               lambda: tmsm.msm_many(x.lag, x.fsc),
               lambda: kernels.g1_msm_fixed(x.tab, x.fsc)),
              ("g1_msm_fixed", "K2 msm_many, 16 keys, 2 MSMs", same_points,
               lambda: tmsm.msm_many(x.lag16, x.fsc16),
               lambda: kernels.g1_msm_fixed(x.tab16, x.fsc16)),
              ("g1_msm_fixed", "ladder + g1_sum (before), 256 keys, 2 MSMs",
               same_points, lambda: aggregation_msms_before(x.lag, x.fsc),
               lambda: kernels.g1_msm_fixed(x.tab, x.fsc)),
              ("g1_msm_fixed", "ladder + g1_sum (before), 16 keys, 2 MSMs",
               same_points,
               lambda: aggregation_msms_before(x.lag16, x.fsc16),
               lambda: kernels.g1_msm_fixed(x.tab16, x.fsc16)),
              # one element: what each of the 418 launches of the inverse
              # cost the host before fr_inv
              ("fr_mul", "one element", same_fr,
               lambda: kernels.fr_mul(x.x1, x.xi1),
               lambda: fr_mul_plain(x.x1, x.xi1)),
              # the challenge's evals as the port took them before
              # fr_eval_rows: a whole opening a row, y kept
              ("fr_eval_rows", OPENINGS, same_fr,
               lambda: openings_y(x.rows, x.alpha),
               lambda: kernels.fr_eval_rows(x.rows, x.alpha))]
    others += [(name, label, same, kern, plain) for (name, label), (
        kern, plain, same, _, _) in extra_shapes(x).items()]
    compare_ms = {}
    for name, label, same, kern, plain in others:
        ms, got = time_cuda(kern, 5)
        compare_ms[name, label], want = time_cuda(plain, 1, warm=False)
        record(name, same(got, want))
        del want
        say(f"[kernels] {name}, {label}, {shape_of(got)}: equal to "
            f"plain; kernel {ms:.4f} ms, the comparison "
            f"{compare_ms[name, label]:.2f} ms")
        res[name].setdefault("other_ms", {})[label] = ms
    for (name, label), (*_, need, _) in extra_shapes(x).items():
        r = res[name]
        ms, plain_ms = r["other_ms"][label], compare_ms[name, label]
        b_ms, b_by = bound(*need, int_ops_per_s)
        r.setdefault("other_bound_ms", {})[label] = b_ms
        r.setdefault("other_plain_ms", {})[label] = plain_ms
        say(f"[kernels] {name} at {label}: {ms:.4f} ms on the host's loop, "
            f"bound {b_ms:.5f} ms ({b_by}), {ms / b_ms:.1f} x it; plain "
            f"{plain_ms:.2f} ms")
    ladder = res["g1_scalar_mul"]
    ladder["other_bound_ms"] = {}
    for label, pts, sc in (("16 points", x.lp16, x.ls16),
                           ("2 x 1024", x.lp2k, x.ls2k),
                           ("2 x 2048", x.lp4k, x.ls4k),
                           ("2^19 points", x.lp512k, x.ls512k)):
        n_pts = pts.shape[0]
        ms = ladder["other_ms"][label]
        b_ms, b_by = bound(2 * G1_BYTES * n_pts + FR_BYTES * n_pts,
                           scalar_mul_ops(sc), int_ops_per_s)
        ladder["other_bound_ms"][label] = b_ms
        form = "group" if kernels.ladder_grouped(n_pts) else "thread"
        say(f"[kernels] g1_scalar_mul at {label} ({form} form): {ms:.4f} ms,"
            f" {LADDER_DEPTH} dependent point operations a point, "
            f"{ms / LADDER_DEPTH * 1e3:.2f} us each; bound {b_ms:.6f} ms "
            f"({b_by}), {ms / b_ms:.1f} x it")
    for n in (1024, 2048):
        say(f"[kernels] two MSMs of {n} points: the naive path "
            "(msm_auto_many: one ladder, one tree of "
            f"{n.bit_length() - 1} g1_add) "
            f"{ladder['other_ms'][f'msm_auto_many, 2 x {n}']:.4f} ms, K2 "
            f"msm_many {ladder['other_ms'][f'K2 msm_many, 2 x {n}']:.4f} ms "
            "(host loop)")
    # the aggregation's 16 inverses: each element's steps on this input and
    # its two closing products, as the one-element row counts them
    res["fr_inv"]["other_bound_ms"] = {"16 elements": bound(
        2 * FR_BYTES * x.diffs.shape[0], inverse_ops(x.diffs),
        int_ops_per_s)[0]}
    say(f"[kernels] fr_inv at 16 elements: steps {inverse_steps(x.diffs)}; "
        f"bound {res['fr_inv']['other_bound_ms']['16 elements']:.7f} ms "
        "(operations)")
    ladder["other_plain_ms"] = {
        label: compare_ms["g1_scalar_mul", label]
        for label in ("16 points", "2 x 1024")}
    say("[kernels] g1_scalar_mul plain: " + ", ".join(
        f"{v:.2f} ms at {k}" for k, v in ladder["other_plain_ms"].items()))
    fixed = res["g1_msm_fixed"]
    fixed["other_plain_ms"] = {
        label: compare_ms["g1_msm_fixed", label]
        for label in ("16 keys, 2 MSMs", "1024 keys, 2 MSMs")}
    fixed["other_bound_ms"] = {
        label: bound(*fixed_msm_need(m, sc), int_ops_per_s)[0]
        for m, label, sc in ((x.m, "16 keys, 2 MSMs", x.fsc16),
                             (WIDE_KEYS, "1024 keys, 2 MSMs", x.fsc1k))}
    for m, label, sc in ((x.tab.shape[0], "256 keys, 2 MSMs", x.fsc),
                         (x.m, "16 keys, 2 MSMs", x.fsc16),
                         (WIDE_KEYS, "1024 keys, 2 MSMs", x.fsc1k)):
        big = m == x.tab.shape[0]
        ms = fixed["ms"] if big else fixed["other_ms"][label]
        b_ms = fixed["bound_ms"] if big else fixed["other_bound_ms"][label]
        plain_ms = (fixed["plain_ms"] if big
                    else fixed["other_plain_ms"][label])
        k2 = fixed["other_ms"][f"K2 msm_many, {label}"]
        old = fixed["other_ms"][f"ladder + g1_sum (before), {label}"]
        own_ms = fixed_kernel_ops(sc) / int_ops_per_s * 1e3
        say(f"[kernels] the aggregation's MSMs at {label}: g1_msm_fixed "
            f"{ms:.4f} ms ({fixed_depth(m)} dependent point adds in "
            f"{len(kernels.fixed_passes(m)) - 1} launches, "
            f"{ms / fixed_depth(m) * 1e3:.2f} us each), K2 msm_many "
            f"{k2:.4f} ms, the ladder + g1_sum before {old:.4f} ms; bound "
            f"{b_ms:.6f} ms (buckets over the table, no doubles), "
            f"{ms / b_ms:.0f} x it; plain {plain_ms:.2f} ms; the kernel's "
            f"own tree of terms {own_ms:.6f} ms at the integer rate"
            + ("; faster than K2" if ms < k2 else
               "; SLOWER than K2: the aggregation should take K2 here"))
    table = res["g1_fixed_table"]
    b1k = bound(*fixed_table_need(x.lag1k), int_ops_per_s)[0]
    table["other_bound_ms"] = {"1024 keys": b1k}
    table["other_plain_ms"] = {
        "1024 keys": compare_ms["g1_fixed_table", "1024 keys"]}
    key_bytes = G1_BYTES * tmsm.FIXED_WINDOWS * tmsm.FIXED_MULTIPLES
    for label, ms, b_ms, plain_ms in (
            ("256 keys", table["ms"], table["bound_ms"], table["plain_ms"]),
            ("1024 keys", table["other_ms"]["1024 keys"], b1k,
             table["other_plain_ms"]["1024 keys"])):
        say(f"[kernels] g1_fixed_table at {label}: {ms:.4f} ms "
            f"({TABLE_DEPTH} dependent point operations, "
            f"{ms / TABLE_DEPTH * 1e3:.2f} us each); bound {b_ms:.6f} ms "
            f"(the 8-bit table's doubles), {ms / b_ms:.0f} x it; plain "
            f"{plain_ms:.2f} ms; {key_bytes} bytes a key")
    time_opening_batch(x, res, int_ops_per_s, record)
    res["fr_butterfly"].update(time_butterfly(rng, dev, int_ops_per_s,
                                              record))
    say(f"[kernels] fr_sub at 2^{LOG_N} elements (for scale; its path's "
        f"shape is {x.m}): "
        f"{time_cuda(lambda: kernels.fr_sub(x.a, x.b), 50)[0]:.4f} ms")
    return res


def extra_shapes(x):
    """{(kernel, label): (call, plain call, comparison, (bytes,
    operations), launches a CUDA graph replays)}: the shapes the paths give
    the scan and the row evaluation besides ``path_calls``' and
    ``batch_calls``': the scan at a default row of 1024 ([default]),
    ``fr_eval_rows`` at [cli]'s challenge (256 rows of 2^16 at one point)
    and one 2^16 row at 16 points (``poly_eval_many``); and the double at
    2^20 points, several waves of the card."""
    n, b = x.n, MESH_BATCH
    row1k = x.a[:1024]
    n20 = x.p20.shape[0]
    return {
        ("g1_double", "2^20 points"): (
            lambda: kernels.g1_double(x.p20),
            lambda: cv.g1_double_plain(x.p20), same_limbs,
            (2 * G1_BYTES * n20, OPS_G1_DOUBLE * n20), 20),
        ("fr_suffix_scan", "1 x 1024"): (
            lambda: kernels.fr_suffix_scan(row1k),
            lambda: tpoly.fr_suffix_scan_plain(row1k), same_fr_pair,
            scan_need(1, 1024), 100),
        ("fr_eval_rows", f"{b} x 2^{LOG_N} at one point"): (
            lambda: kernels.fr_eval_rows(x.batch, x.alpha),
            lambda: tpoly.fr_eval_rows_plain(x.batch, x.alpha), same_fr,
            eval_need(b, n, b, 1), 10),
        ("fr_eval_rows", f"1 x 2^{LOG_N} at {x.m} points"): (
            lambda: kernels.fr_eval_rows(x.a[None], x.pts16),
            lambda: tpoly.fr_eval_rows_plain(x.a[None], x.pts16), same_fr,
            eval_need(x.m, n, 1, x.m), 50)}


def batch_calls(x):
    """{(kernel, label): (call, plain call on BATCH_SAMPLED rows, (bytes,
    operations), launches a CUDA graph replays)} at [mesh]'s batch of
    MESH_BATCH rows of 2^16 at one point: the opening's kernels, one launch
    each, and the whole opening (1/x given) of one row and of the batch,
    under ``fr_open_quotient``."""
    n, b, rows = x.n, MESH_BATCH, list(BATCH_SAMPLED)
    label = f"{b} x 2^{LOG_N}"

    def need(rows_):
        parts = (powers_need(rows_, n), scan_need(rows_, n),
                 quotient_need(rows_, n))
        return tuple(sum(p[i] for p in parts) for i in range(2))
    return {
        ("fr_powers", label): (
            lambda: kernels.fr_powers(x.tab1[0], n, x.batch),
            lambda: fr_powers_plain(x.tab1[0], n, x.batch[rows]),
            powers_need(b, n), 10),
        ("fr_suffix_scan", label): (
            lambda: tpoly._scan_on_card(x.batch),
            lambda: tpoly.fr_suffix_scan_plain(x.batch[rows]),
            scan_need(b, n), 10),
        ("fr_open_quotient", label): (
            lambda: kernels.fr_open_quotient(x.blocal, x.btotals, x.x1,
                                             x.tab1[1], x.batch),
            lambda: tpoly.fr_open_quotient_plain(
                x.blocal[rows], x.btotals[rows], x.x1, x.tab1[1],
                x.batch[rows]), quotient_need(b, n), 10),
        ("fr_open_quotient", "whole opening, 1 row"): (
            lambda: tpoly._open_on_card(x.a, x.x1, x.xi1),
            lambda: tpoly.open_pieces_plain(x.a, x.x1, xi=x.xi1),
            need(1), 20),
        ("fr_open_quotient", f"whole opening, {label}"): (
            lambda: tpoly._open_on_card(x.batch, x.x1, x.xi1),
            lambda: tpoly.open_pieces_plain(x.batch[rows], x.x1, xi=x.xi1),
            need(b), 5)}


def time_opening_batch(x, res, int_ops_per_s, record):
    """``batch_calls`` on the host's loop: each against its plain version
    (on BATCH_SAMPLED rows of the batch), its ms a call and its bound
    (``other_ms``, ``other_bound_ms``)."""
    rows = list(BATCH_SAMPLED)
    for (name, label), (kern, plain, (nbytes, ops), _) in \
            batch_calls(x).items():
        ms, got = time_cuda(kern, 5)
        if "1 row" not in label:
            got = tuple(t[rows] for t in got) if isinstance(got, tuple) \
                else got[rows]
        same = same_fr_pair if isinstance(got, tuple) else same_fr
        plain_ms, want = time_cuda(plain, 1, warm=False)
        record(name, same(got, want))
        del got, want
        b_ms, b_by = bound(nbytes, ops, int_ops_per_s)
        sampled = '0' if '1 row' in label else rows
        res[name].setdefault("other_ms", {})[label] = ms
        res[name].setdefault("other_bound_ms", {})[label] = b_ms
        res[name].setdefault("other_plain_ms", {})[
            f"{label}, rows {sampled}"] = plain_ms
        say(f"[kernels] {name}, {label}: equal to plain (rows {sampled}); "
            f"{ms:.4f} ms a call on the host's loop, bound {b_ms:.5f} ms "
            f"({b_by}), {ms / b_ms:.1f} x it; plain {plain_ms:.2f} ms on "
            f"rows {sampled}")


def phase_fixed_msm_kernels(rng, dev, record):
    """K1 ``g1_fixed_table`` and ``g1_msm_fixed`` (the aggregation's MSMs)
    against their plain versions, limb for limb (on CPU copies at 16 keys,
    on the card at 256 and 1024), and the MSMs against the oracle: keys of
    known discrete log with Z != 1, one at infinity; three MSMs a call, the
    first
    with scalars 0, 1, r - 1 and r - 2 then random, the second random, the
    third all r - 1."""
    g = o.G1.from_affine(o.G1_GEN)
    for m in (16, 256, WIDE_KEYS):
        pts, logs = random_points(rng, m, dev)
        pts[3] = cv.g1_infinity((), dev)
        logs[3] = 0
        ks = [[0, 1, o.R - 1, o.R - 2]
              + limbs_to_ints(random_scalar_limbs(rng, m - 4)),
              limbs_to_ints(random_scalar_limbs(rng, m)), [o.R - 1] * m]
        sc = torch.stack([cv.fr_to_scalar_limbs(k, dev) for k in ks])
        table = kernels.g1_fixed_table(pts)
        got = kernels.g1_msm_fixed(table, sc)
        on = (lambda t: t) if m > 16 else (lambda t: t.cpu())
        record("g1_fixed_table", same_limbs(
            table, tmsm.fixed_table_plain(on(pts))))
        record("g1_msm_fixed", same_limbs(
            got, tmsm.msm_fixed_plain(on(table), on(sc))))
        for c, k in enumerate(ks):
            total = sum(a * b for a, b in zip(k, logs)) % o.R
            check(cv.g1_affine(got[c])[0]
                  == o.G1.to_affine(o.G1.mul(g, total)),
                  f"g1_msm_fixed at {m} keys: MSM {c} != oracle")
    say("[kernels] K1 g1_fixed_table and g1_msm_fixed at 16, 256 and "
        f"{WIDE_KEYS} keys (one at infinity), 3 MSMs a call (scalars 0, 1, "
        "r-1, r-2, random; all r-1): equal limb for limb to plain; the MSMs "
        "equal the oracle")


def phase_opening_kernels(rng, dev, record):
    """K3's opening kernels against their plain versions (on CPU copies;
    at 2^16 and more on the card): ``fr_inv`` on 0, 1, r − 1, r − 2, the 16
    differences β − ω^i of the aggregation and random values;
    ``fr_power_tables`` (of x and 1/x, and of x alone) and ``fr_powers``
    (no c, one row, four rows) at x = 0, 1, r − 1 and random, n = 1, 1000,
    3000, 2^16 and THREE_LEVELS; the two scan passes on one row and on four
    at once (random, zeros, 2^16, 3000: no multiple of the tile,
    THREE_LEVELS), at the same points; the whole opening of those rows
    (``poly_open_scalars``) against the plain versions composed and, for
    four rows, against each row's own opening, while the host may not wait
    for the card (``torch.cuda.set_sync_debug_mode("error")``: no value of
    x comes back); ``poly_eval_and_quotient`` against the same, and
    ``poly_eval`` (K3 ``fr_eval_rows``) against their y."""
    vals = random_fr(rng, 64, dev)                 # 0, 1, r−1, r−2, random
    diffs = FR.sub(vals[10], aggregation_dom(1 << ROUND_MACHINES_SCALE, dev))
    # the limbs 1 (the Montgomery form of 1/R) take the inverse's doubling
    # before its closing products
    one_limb = FR.ints_to_limbs([1], dev)
    for t in (vals, diffs, vals[:1], vals[1:2], one_limb):
        record("fr_inv", same_fr(kernels.fr_inv(t.contiguous()),
                                 fr_inv_plain(t.cpu())))
    both = torch.cat([vals, diffs, one_limb])
    check(FR.decode(kernels.fr_inv(both))
          == [pow(v, o.R - 2, o.R) for v in FR.decode(both)],
          "fr_inv != the oracle's x^(r-2)")
    xs = [vals[i].contiguous() for i in (0, 1, 2, 9)]
    big = 1 << LOG_N

    def four(c):
        """Four distinct rows from one."""
        return torch.stack([c, c.roll(1, 0), c.flip(0), FR.mont_mul(c, c)])
    for n_pow in (1, 1000, 3000, big, THREE_LEVELS):
        c = random_fr(rng, n_pow, dev)
        c4 = four(c)
        on = (lambda t: t.cpu()) if n_pow < big else (lambda t: t)
        for x in xs:
            xi = kernels.fr_inv(x)
            tables = kernels.fr_power_tables(x, n_pow, xi)
            want = fr_power_tables_plain(on(x), n_pow, on(xi))
            record("fr_power_tables", same_limbs(tables, want))
            record("fr_power_tables", same_limbs(
                kernels.fr_power_tables(x, n_pow), want[:1]))
            t0 = on(tables[0])
            for cc in (None, c, c4):
                record("fr_powers", same_fr(
                    kernels.fr_powers(tables[0], n_pow, cc),
                    fr_powers_plain(t0, n_pow, None if cc is None
                                    else on(cc))))
    levels = kernels.fr_power_tables(xs[3], THREE_LEVELS).shape[1]
    check(levels == 3, f"{THREE_LEVELS} powers: {levels} levels, not 3")
    say("[kernels] K3 fr_power_tables (x and 1/x; x alone) and fr_powers "
        "(no c, one row, four rows) at x = 0, 1, r-1, random, n = 1, 1000, "
        f"3000, 2^{LOG_N}, {THREE_LEVELS} (three levels): equal to plain "
        "limb for limb")
    rand = random_fr(rng, big, dev)
    three = random_fr(rng, THREE_LEVELS, dev)
    short = random_fr(rng, 3000, dev)
    tile = tpoly.SCAN_TILE
    rows = (("random", rand), ("all zeros", FR.zeros((big,), dev)),
            ("3000 coefficients", short),
            (f"{tile - 1} coefficients, a tile less one", short[:tile - 1]),
            (f"{tile + 1} coefficients, one past a tile", short[:tile + 1]),
            ("1024 coefficients, a default row", short[:1024]),
            (f"{THREE_LEVELS} coefficients", three),
            (f"4 rows of 2^{LOG_N}", four(rand)),
            ("4 rows of 3000", four(short)),
            (f"4 rows of {THREE_LEVELS}", four(three)))
    for label, c in rows:
        batched = c.dim() == 3
        local, totals = tpoly._scan_on_card(c if batched else c[None])
        if not batched:
            local, totals = local[0], totals[0]
        record("fr_suffix_scan", same_fr_pair(
            (local, totals), tpoly.fr_suffix_scan_plain(c)))
        if not batched:
            record("fr_suffix_scan", same_fr_pair(
                (local, totals), kernels.fr_suffix_scan(c)))
        for x in xs:
            tables = kernels.fr_power_tables(x, c.shape[-2],
                                             kernels.fr_inv(x))
            record("fr_open_quotient", same_fr_pair(
                kernels.fr_open_quotient(local, totals, x, tables[1], c),
                tpoly.fr_open_quotient_plain(local, totals, x, tables[1],
                                             c)))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = tpoly.poly_open_scalars(c, x)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            record("fr_open_quotient", same_fr_pair(
                got, tpoly.open_pieces_plain(c, x)))
            if batched:
                for b in range(c.shape[0]):
                    record("fr_open_quotient", same_fr_pair(
                        (got[0][b], got[1][b]),
                        tpoly.poly_open_scalars(c[b], x)))
                continue
            y, q = tpoly.poly_eval_and_quotient(c, x)
            y_plain, q_plain = tpoly.open_pieces_plain(c, x)
            record("fr_open_quotient", same_fr_pair(
                (y, q), (y_plain, FR.to_mont(q_plain[:-1]))))
            record("fr_eval_rows", same_fr(tpoly.poly_eval(c, x), y_plain))
        say(f"[kernels] K3 fr_suffix_scan / fr_open_quotient ({label}, "
            f"{tuple(local.shape)} in tiles of {tpoly.SCAN_TILE}), at x = 0, "
            "1, r-1 and random: equal to plain; poly_open_scalars equals "
            "the plain versions composed, with no wait for the card on the "
            "host"
            + (", and each row's own opening" if batched else
               ", and so does poly_eval_and_quotient; poly_eval "
               "(fr_eval_rows) gives the same y"))
    x_int = FR.decode(xs[3])[0]
    check(FR.decode(tpoly.poly_open_scalars(short, xs[3])[0])
          == [o.poly_eval(FR.decode(short), x_int)], "opening: y != f(x)")
    say("[kernels] K3 fr_inv (64 values incl. 0, 1, r-1, r-2; the 16 "
        "aggregation differences; the limbs 1), also equal to the oracle: "
        "equal to plain; y of the 3000-coefficient row equals the oracle's "
        "f(x)")


def phase_eval_rows_kernel(rng, dev, record):
    """K3 ``fr_eval_rows`` against its plain version (on CPU copies; at
    16 x 2^16 and past 32 tiles on the card), tolerance 0: 4 rows, each at
    its own x of 0, 1, r - 1 and random, and all 4 at each x; a row of zeros
    among them; one row; n = 1, one past a warp's run (a tile's eighth),
    1024, 1025, 3000, a tile less one, one tile (EVAL_TILE), one past it;
    every n from 2 to 33 (a lane's Horner run of one step, then two), four
    rows at their own x; 33 tiles and 5 (the second pass's Horner steps
    over a lane's tiles), two rows; one polynomial at 16 points
    (``poly_eval_many``); and the challenge's 16 x 2^16 at one point through
    ``poly_eval``, with the host forbidden to wait for the card, and row 0
    against the oracle."""
    xs = random_fr(rng, 5, dev)[[0, 1, 2, 4]].contiguous()  # 0, 1, r−1, rand
    cases = []
    tile = kernels.EVAL_TILE
    for n in (1, tile // 8 + 1, 1024, 1025, 3000, tile - 1, tile, tile + 1):
        c = random_fr(rng, 4 * n, dev).view(4, n, 8).clone()
        c[1] = 0
        cases += [(f"4 x {n}, own x", c, xs)]
        cases += [(f"4 x {n}, x = {label}", c, xs[i:i + 1].contiguous())
                  for i, label in enumerate(("0", "1", "r-1", "random"))]
        cases += [(f"1 x {n}", c[2:3].contiguous(), xs[3:4].contiguous())]
    for n in range(2, 34):
        cases.append((f"4 x {n}, own x", random_fr(rng, 4 * n, dev).view(
            4, n, 8), xs))
    for label, c, x in cases:
        record("fr_eval_rows", same_fr(kernels.fr_eval_rows(c, x),
                                       tpoly.fr_eval_rows_plain(c.cpu(),
                                                                x.cpu())))
    wide = random_fr(rng, 2 * (33 * tile + 5), dev).view(2, -1, 8)
    record("fr_eval_rows", same_fr(kernels.fr_eval_rows(wide, xs[2:]),
                                   tpoly.fr_eval_rows_plain(wide, xs[2:])))
    row = random_fr(rng, 3000, dev)
    pts = random_fr(rng, 16, dev)
    got = tpoly.poly_eval_many(row, pts)
    record("fr_eval_rows", same_fr(got, tpoly.fr_eval_rows_plain(
        row[None].cpu(), pts.cpu())))
    check(FR.decode(got[4:6]) == [o.poly_eval(FR.decode(row), v)
                                  for v in FR.decode(pts[4:6])],
          "poly_eval_many != oracle")
    m, n = 1 << ROUND_MACHINES_SCALE, 1 << LOG_N
    limbs = random_scalar_limbs(rng, m * n).reshape(m, n, 16)
    rows = fr_from_canonical_limbs(limbs, dev)
    alpha = random_fr(rng, 5, dev)[4].contiguous()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tpoly.poly_eval(rows, alpha)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    record("fr_eval_rows", same_fr(got, tpoly.fr_eval_rows_plain(
        rows, alpha.view(1, 8))))
    check(FR.decode(got[:1]) == [o.poly_eval(limbs_to_ints(limbs[0]),
                                             FR.decode(alpha)[0])],
          "fr_eval_rows: row 0 != oracle")
    say(f"[kernels] K3 fr_eval_rows: {len(cases)} cases (4 rows at x = 0, "
        "1, r-1, random, each its own or all one; a row of zeros; one row; "
        f"n = 1 to 33, {tile // 8 + 1}, 1024, 1025, 3000, {tile - 1}, "
        f"{tile}, {tile + 1}), 2 rows of {33 * tile + 5} (34 tiles), "
        "poly_eval_many of one row at 16 points, "
        f"and poly_eval of {m} x 2^{LOG_N} rows at one x with no wait for "
        "the card on the host: equal to plain; row 0 and two of the 16 "
        "points equal the oracle")


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
    x = path_inputs(rng, dev)
    calls = {name: call[0] for name, call in path_calls(x).items()}
    v, tw = butterfly_inputs(rng, dev)
    calls["fr_butterfly"] = lambda: kernels.fr_butterfly(v, tw, LOG_N // 2)
    graph_launches = {"fq_mul": 20, "fq_add": 20, "fq_sub": 20,
                      "msm_buckets": 5, "msm_reduce": 5, "msm_combine": 5,
                      "g1_scalar_mul": 2, "fr_inv": 20,
                      "g1_fixed_table": 2, "g1_msm_fixed": 20}
    for name, r in res.items():
        r["device_ms"] = time_graph(calls[name],
                                    graph_launches.get(name, 100))
    # the shapes of the aggregation and of one launch of the old inverse
    others = {("g1_scalar_mul", "16 points, device"): (
                  lambda: kernels.g1_scalar_mul(x.lp16, x.ls16), 5),
              ("g1_scalar_mul", "2 x 1024, device"): (
                  lambda: kernels.g1_scalar_mul(x.lp2k, x.ls2k), 5),
              ("g1_scalar_mul", "2 x 2048, device"): (
                  lambda: kernels.g1_scalar_mul(x.lp4k, x.ls4k), 5),
              ("g1_scalar_mul", "2^19 points, device"): (
                  lambda: kernels.g1_scalar_mul(x.lp512k, x.ls512k), 2),
              ("g1_scalar_mul", "2 x 1024, the other form, device"): (
                  lambda: kernels._ladder(x.lp2k, x.ls2k, False), 5),
              ("g1_scalar_mul", "2^16 points, the other form, device"): (
                  lambda: kernels._ladder(x.lp, x.ls, True), 2),
              ("g1_scalar_mul", "msm_auto_many, 2 x 1024, device"): (
                  lambda: tmsm.msm_auto_many(x.lp[:1024],
                                             x.ls2k.view(2, -1, 8)), 5),
              ("g1_scalar_mul", "K2 msm_many, 2 x 1024, device"): (
                  lambda: tmsm.msm_many(x.lp[:1024], x.ls2k.view(2, -1, 8)),
                  5),
              ("g1_scalar_mul", "msm_auto_many, 2 x 2048, device"): (
                  lambda: tmsm.msm_auto_many(x.lp[:2048],
                                             x.ls4k.view(2, -1, 8)), 5),
              ("g1_scalar_mul", "K2 msm_many, 2 x 2048, device"): (
                  lambda: tmsm.msm_many(x.lp[:2048], x.ls4k.view(2, -1, 8)),
                  5),
              ("fr_inv", "16 elements, device"): (
                  lambda: kernels.fr_inv(x.diffs), 20),
              ("fr_mul", "one element, device"): (
                  lambda: kernels.fr_mul(x.x1, x.xi1), 100),
              ("fr_eval_rows", OPENINGS + ", device"): (
                  lambda: openings_y(x.rows, x.alpha), 5),
              ("g1_msm_fixed", "16 keys, 2 MSMs, device"): (
                  lambda: kernels.g1_msm_fixed(x.tab16, x.fsc16), 20),
              ("g1_msm_fixed", "1024 keys, 2 MSMs, device"): (
                  lambda: kernels.g1_msm_fixed(x.tab1k, x.fsc1k), 10),
              ("g1_fixed_table", "1024 keys, device"): (
                  lambda: kernels.g1_fixed_table(x.lag1k), 2),
              ("g1_msm_fixed", "K2 msm_many, 1024 keys, 2 MSMs, device"): (
                  lambda: tmsm.msm_many(x.lag1k, x.fsc1k), 5),
              ("g1_msm_fixed", "ladder + g1_sum (before), 256 keys, 2 "
               "MSMs, device"): (
                  lambda: aggregation_msms_before(x.lag, x.fsc), 2),
              ("g1_msm_fixed", "K2 msm_many, 256 keys, 2 MSMs, device"): (
                  lambda: tmsm.msm_many(x.lag, x.fsc), 5),
              ("g1_msm_fixed", "K2 msm_many, 16 keys, 2 MSMs, device"): (
                  lambda: tmsm.msm_many(x.lag16, x.fsc16), 5)}
    others.update({(name, label + ", device"): (call[0], call[3])
                   for (name, label), call in batch_calls(x).items()})
    others.update({(name, label + ", device"): (call[0], call[4])
                   for (name, label), call in extra_shapes(x).items()})
    for (name, label), (fn, launches) in others.items():
        ms = time_graph(fn, launches)
        res[name].setdefault("other_ms", {})[label] = ms
        say(f"[device] {name}, {label.removesuffix(', device')}: {ms:.4f} "
            "ms a call by graph replay")
    for name, r in res.items():
        r["profiler_ms"] = time_profiler(calls[name], 20)
        prof = ("no device time" if r["profiler_ms"] is None
                else f"{r['profiler_ms']:.4f} ms")
        say(f"[device] {name}: {r['device_ms']:.4f} ms a launch by graph "
            f"replay, {prof} by torch.profiler; host's loop {r['ms']:.4f} "
            f"ms; {r['device_ms'] / r['bound_ms']:.1f} x its bound")


def build_srs(dev):
    """A one-worker SRS (scale 16, machines_scale 0) whose row is the
    2^16-base slice [τ^j]G1: τ^j by K3 ``fr_powers``, the points by one
    launch of the K1 ladder ``g1_scalar_mul``."""
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


def selfcheck(resp, row_ints, x_int, commit_only, tau=TAU, key=1):
    """The trapdoor check of bench.py:selfcheck_prove on wire outputs, for
    bases [key·τ^j]G1 (a Pianist worker's key is R_i(τ_Y))."""
    g = o.G1.mul(o.G1.from_affine(o.G1_GEN), key)
    f_tau = o.poly_eval(row_ints, tau)
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
    q_tau = (f_tau - y) * pow((tau - x_int) % o.R, o.R - 2, o.R) % o.R
    check(o.G1.to_affine(enc.g1_from_b64(resp.proof))
          == o.G1.to_affine(o.G1.mul(g, q_tau)), "proof != [q(tau)]G1")


def check_request_launches(used, label):
    """One request's launches: one of each K2 kernel (a batched commit +
    opening), the opening in five K3 launches (one each of fr_inv, the
    tables, fr_powers and the two scan passes; no fr_add), at most seven
    K3-family launches in all, and no K1 double or ladder."""
    for k in ("msm_buckets", "msm_reduce", "msm_combine", "fr_inv")\
            + OPENING:
        check(used[k] == 1, f"{label}: {used[k]} {k} launches, not 1")
    for k in ("fr_add", "g1_double", "g1_scalar_mul"):
        check(used[k] == 0, f"{label}: {used[k]} {k} launches, not 0")
    k3 = sum(used[k] for k in K3_FAMILY)
    check(k3 <= 7, f"{label}: {k3} K3-family launches, more than 7")
    check(used["g1_add"] > 0 and used["fr_mul"] > 0,
          f"{label}: no g1_add or fr_mul launch")


def phase_main_path(rng, dev):
    n = 1 << LOG_N
    kernels.reset_launches()
    t0 = time.perf_counter()
    srs = build_srs(dev)
    torch.cuda.synchronize()
    setup = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(setup.get("g1_scalar_mul") == 1 and "g1_double" not in setup,
          f"build_srs: not one ladder launch and no K1 double: {setup}")
    say(f"[main] SRS slice of {n} bases [tau^j]G1 built on the card in "
        f"{time.perf_counter() - t0:.2f} s; 5 bases match the oracle; "
        f"setup launches {setup}")
    worker = Worker(srs)

    def request(commit_only, limbs=None):
        limbs = random_scalar_limbs(rng, n) if limbs is None else limbs
        x_int = None if commit_only else \
            int.from_bytes(rng.bytes(32), "little") % o.R
        syn = Prove(index=0, poly=enc.limbs_to_b64(limbs),
                    alpha=None if commit_only else enc.fr_to_b64(x_int))
        t = time.perf_counter()
        resp = worker.forward(syn)
        torch.cuda.synchronize()
        return resp, limbs, x_int, time.perf_counter() - t

    first_s, per_request = None, None
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
        check_request_launches(used, f"request {i}")
        per_request = per_request or used
        kind = "commit-only" if commit_only else "commit+open"
        say(f"[main] request {i} ({kind}, {n} coefficients): {dt:.3f} s, "
            f"trapdoor self-check PASS"
            + ("" if commit_only else ", pairing verify PASS")
            + f"; launches {({k: v for k, v in used.items() if v})}")
    launches = dict(kernels.LAUNCHES)
    for k in ("g1_add", "g1_scalar_mul", "msm_buckets", "msm_reduce",
              "msm_combine", "fr_mul", "fr_inv") + OPENING:
        check(launches[k] > 0, f"main path never launched {k}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(WARM_REQUESTS):
        before = dict(kernels.LAUNCHES)
        resp, _, _, dt = request(False)
        check_request_launches(
            {k: kernels.LAUNCHES[k] - before[k] for k in before},
            f"warm request {i}")
        check(resp.commitment is not None and resp.proof is not None,
              "warm request failed")
        times.append(dt)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times) * 1e3
    say(f"[main] first request {first_s:.3f} s (includes warm-up); warm "
        f"commit+open of a 2^{LOG_N} row: median {med:.2f} ms over "
        f"{len(times)} ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms); "
        f"peak device memory {peak / 2**20:.1f} MiB")

    # skewed rows, as Pianist wire polynomials are (most witness values 0
    # or 1): three with 90% zeros and ones and 10% random coefficients, and
    # one of all ones; each checked like the requests above
    def skewed():
        limbs = np.zeros((n, 16), np.uint32)
        kind = rng.random(n)
        limbs[kind < 0.45, 0] = 1                          # 45% ones
        rand = kind >= 0.9                                 # 10% random
        limbs[rand] = random_scalar_limbs(rng, int(rand.sum()))
        return limbs                                       # 45% zeros

    ones = np.zeros((n, 16), np.uint32)
    ones[:, 0] = 1
    skew_times = []
    for label, limbs in [("90% zeros and ones", skewed()) for _ in range(3)
                         ] + [("all ones", ones)]:
        before = dict(kernels.LAUNCHES)
        resp, limbs, x_int, dt = request(False, limbs)
        used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        selfcheck(resp, limbs_to_ints(limbs), x_int, False)
        check(worker.worker_verify(0, resp.proof, resp.alpha, resp.eval_,
                                   resp.commitment),
              f"worker_verify rejected the {label} request's proof")
        check_request_launches(used, f"{label} request")
        skew_times.append(dt)
        say(f"[main] skewed request ({label}): {dt * 1e3:.2f} ms, trapdoor "
            "self-check PASS, pairing verify PASS; one launch of each K2 "
            "kernel, the opening in five K3 launches")
    say(f"[main] skewed 2^{LOG_N} rows: median "
        f"{statistics.median(skew_times) * 1e3:.2f} ms over "
        f"{len(skew_times)} ({', '.join(f'{t * 1e3:.2f}' for t in skew_times)}"
        f" ms) beside the random rows' median {med:.2f} ms")
    host_split(worker, rng)
    return launches, setup, per_request


def host_split(worker, rng, label="[main]", index=0):
    """Where one warm request's time goes: ``Worker.forward``'s steps run
    one by one with ``torch.cuda.synchronize()`` between them, median of
    ``WARM_REQUESTS`` requests, beside ``Worker.forward``'s own total on
    the same requests; the staged outputs must be the forward's wire
    strings. A row of at most NAIVE_THRESHOLD coefficients takes the
    naive MSM (one ladder and one tree) in place of bucket_runs and K2."""
    n = worker.srs.row_size
    naive = n <= tmsm.NAIVE_THRESHOLD
    bases = worker.srs.device_worker_bases(index)
    groups = tmsm._groups(n)
    msm_stages = (("K1 ladder + one g1_add tree (msm_auto_many)",) if naive
                  else ("bucket_runs (digits, sort)",
                        "K2 + K1 (buckets, reduce, folds, combine)"))
    stages = ("b64 -> limbs", "limbs -> card + to_mont", "alpha encode",
              "opening K3 (+ from_mont_wide)", *msm_stages,
              "g1_decode + g1_to_b64 (and eval b64)")
    split = {k: [] for k in stages}
    totals = []
    for _ in range(WARM_REQUESTS):
        limbs = random_scalar_limbs(rng, n)
        syn = Prove(index=index, poly=enc.limbs_to_b64(limbs),
                    alpha=enc.fr_to_b64(int.from_bytes(rng.bytes(32),
                                                       "little") % o.R))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = worker.forward(syn)
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - t0) * 1e3)
        out = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            split[name].append((time.perf_counter() - t) * 1e3)
            return out[name]

        got = stage(stages[0], lambda: enc.b64_to_limbs(syn.poly))
        row = stage(stages[1], lambda: FR.to_mont(FR.from_limbs16(
            got, worker.device)))
        x = stage(stages[2], lambda: FR.encode(
            [enc.fr_from_b64(syn.alpha)], worker.device)[0])

        def opening():
            y, quotient = tpoly.poly_open_scalars(row, x)
            return y, torch.stack([tpoly.from_mont_wide(row), quotient])

        y, scalars = stage(stages[3], opening)
        if naive:
            com_prf = stage(stages[4], lambda: tmsm.msm_auto_many(bases,
                                                                 scalars))
        else:
            perm, digits = stage(stages[4], lambda: tmsm.bucket_runs(
                scalars, groups))

            def k2_k1():
                sums = tmsm.msm_reduce(tmsm.msm_buckets(bases, perm, digits))
                g = groups
                while g > 1:
                    half = sums.shape[0] // 2
                    sums = cv.g1_add(sums[:half], sums[half:])
                    g //= 2
                return tmsm.msm_combine(sums.view(2, tmsm.NUM_WINDOWS, 3,
                                                  12))

            com_prf = stage(stages[5], k2_k1)
        wire = stage(stages[-1], lambda: [
            enc.g1_to_b64(cv.g1_decode(p)[0], worker.compressed)
            for p in com_prf] + [enc.fr_to_b64(FR.decode(y)[0])])
        check(wire == [want.commitment, want.proof, want.eval_],
              "host split: the staged request != Worker.forward's")
    med = {k: statistics.median(v) for k, v in split.items()}
    say(f"{label} host split of a warm {n}-coefficient request, median of "
        f"{WARM_REQUESTS} (synchronized between stages; the staged outputs "
        "equal Worker.forward's): " + "; ".join(
            f"{k} {v:.2f} ms" for k, v in med.items())
        + f"; sum {sum(med.values()):.2f} ms beside Worker.forward's "
        f"median {statistics.median(totals):.2f} ms")
    return med


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

    # 256 of the comb's outputs against g1_scalar_mul (the K1 ladder)
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
    check(agg_launches.get("fr_inv") == 1
          and agg_launches.get("g1_msm_fixed") == 1
          and agg_launches.get("g1_fixed_table") == 1
          and "g1_scalar_mul" not in agg_launches
          and "g1_double" not in agg_launches,
          f"aggregate: not one fr_inv, one g1_msm_fixed and the keys' table "
          f"once, with no ladder and no K1 double ({agg_launches})")
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

    # 5. the coordinator's own round on the same SRS
    phase_coordinator(srs, rng, dev)

    # 6. launch counts of this path
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        # the double runs inside the ladder's kernel, never on its own
        check(v == 0 if k == "g1_double" else v > 0,
              f"the round path launched {k} {v} times")
    say(f"[round] launches {launches}")

    # after the counts are read: the aggregation warm, on the host's clock
    times = []
    before = dict(kernels.LAUNCHES)
    for _ in range(AGGREGATE_WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = pianist.aggregate(srs, coms_t, prfs_t, ys_t, beta_t)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(again.proof_y, agg.proof_y)
              and torch.equal(again.value, agg.value),
              "a repeated aggregate gave another proof")
    warm = {k: (v - before[k]) // AGGREGATE_WARM_RUNS
            for k, v in kernels.LAUNCHES.items() if v != before[k]}
    check(warm.get("g1_msm_fixed") == 1 and "g1_fixed_table" not in warm
          and warm.get("fr_inv") == 1,
          f"a warm aggregate: not one g1_msm_fixed and one fr_inv without "
          f"the table ({warm})")
    say(f"[round] pianist.aggregate warm: median "
        f"{statistics.median(times):.2f} ms over {len(times)} "
        f"({', '.join(f'{t:.2f}' for t in times)} ms); launches a call "
        f"{warm} (the keys' table kept by the SRS)")
    return launches


def phase_aggregate_wide(rng, dev):
    """The aggregation past 512 workers: an SRS at machines_scale 10
    (``Srs.generate``; 1024 workers x 2^6 coefficients), every row committed
    and opened at one alpha (``commit_all``, ``open_all``), then
    ``pianist.aggregate`` (one ``g1_fixed_table`` and one ``g1_msm_fixed``
    over the 1024 keys) and ``verify_aggregated``: True, and False for a
    proof aggregated from one changed eval and for a changed value."""
    m = 1 << WIDE_MACHINES_SCALE
    t = 1 << (WIDE_SCALE - WIDE_MACHINES_SCALE)
    t0 = time.perf_counter()
    srs = Srs.generate(WIDE_SCALE, WIDE_MACHINES_SCALE, tau_x=TAU,
                       tau_y=TAU_Y)
    rows = fr_from_canonical_limbs(
        random_scalar_limbs(rng, m * t).reshape(m, t, 16), dev)
    alpha = int.from_bytes(rng.bytes(32), "little") % o.R
    beta = int.from_bytes(rng.bytes(32), "little") % o.R
    coms = pianist.commit_all(srs, rows)
    ys, prfs = pianist.open_all(srs, rows, FR.encode([alpha], dev)[0])
    beta_t = FR.encode([beta], dev)[0]
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    agg = pianist.aggregate(srs, coms, prfs, ys, beta_t)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v - before[k]}
    check(used.get("g1_msm_fixed") == 1 and used.get("g1_fixed_table") == 1
          and "g1_scalar_mul" not in used,
          f"aggregate over {m} keys: not one table and one g1_msm_fixed "
          f"without the ladder ({used})")
    check(srs.lagrange_table().shape[0] == m,
          f"the keys' table holds {srs.lagrange_table().shape[0]} keys")
    check(pianist.verify_aggregated(srs, agg, alpha, beta),
          f"verify_aggregated rejected the aggregation of {m} workers")
    bad_ys = ys.clone()
    bad_ys[m // 2] = FR.add(ys[m // 2], FR.ones((), dev))
    forged = pianist.aggregate(srs, coms, prfs, bad_ys, beta_t)
    check(not pianist.verify_aggregated(srs, forged, alpha, beta),
          f"verify_aggregated accepted {m} workers with one eval changed")
    forged = dataclasses.replace(agg, value=FR.encode([1], dev)[0])
    check(not pianist.verify_aggregated(srs, forged, alpha, beta),
          f"verify_aggregated accepted {m} workers with the value changed")
    say(f"[round] machines_scale {WIDE_MACHINES_SCALE}: Srs.generate("
        f"{WIDE_SCALE}, {WIDE_MACHINES_SCALE}) and {m} rows of 2^"
        f"{WIDE_SCALE - WIDE_MACHINES_SCALE} committed and opened in "
        f"{t_prove:.2f} s; pianist.aggregate over {m} keys {t_agg * 1e3:.2f} "
        f"ms the first call ({used}); verify_aggregated True, False with one "
        "eval changed, False with the value changed")


def coordinator_round(coord, transport, label):
    """One ``Coordinator.run_round``, timed; every response must carry its
    commitment and proof (a failed Worker.forward returns the request
    unchanged, which would only score 0)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    challenge, responses, rewards = coord.run_round(transport)
    dt = time.perf_counter() - t0
    m = coord.srs.machines
    check(len(responses) == m, f"{label}: {len(responses)} responses, not {m}")
    for i, r in enumerate(responses):
        check(r.commitment and r.proof and r.eval_,
              f"{label}: response {i} lacks its commitment or proof "
              f"(status {r.status_code})")
    return challenge, responses, rewards, dt


def phase_coordinator(srs, rng, dev):
    """The coordinator's round on the [round] SRS (16 workers x 2^16):
    ``generate_challenge`` (one fr_eval_rows, no fr_inv; row 0's eval
    against the oracle), ``run_round`` through LocalTransport (one Worker a
    uid, called from executor threads) and through HttpTransport against a
    WorkerServer on 127.0.0.1 with the card behind it, every reward > 0;
    MockTransport with one corrupt uid (exactly 0, the rest > 0);
    ``aggregate_responses`` on the complete set (``verify_aggregated``);
    then the scores, the weights and ``state.npz`` through a temporary
    directory."""
    m = srs.machines
    hotkeys = [f"hk{i}" for i in range(m)]
    coord = trt.Coordinator(srs, trt.CoordinatorConfig(sample_size=m,
                                                       timeout=COORDINATOR_TIMEOUT),
                            hotkeys, seed=SEED)
    check(coord.generator.device.type == "cuda",
          "the coordinator does not draw on the card")
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    challenge = coord.generate_challenge(m)
    t_challenge = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    check(1 <= used.get("fr_eval_rows", 0) <= 2 and "fr_inv" not in used,
          f"generate_challenge: not 1-2 fr_eval_rows and no fr_inv: {used}")
    row0 = enc.poly_from_b64(challenge.polys[0])
    alpha = enc.fr_from_b64(challenge.alpha)
    check(enc.fr_from_b64(challenge.evals[0]) == o.poly_eval(row0, alpha),
          "challenge: row 0's eval != oracle.poly_eval")
    say(f"[round] Coordinator.generate_challenge({m}): {t_challenge:.3f} s "
        f"({m} x 2^{LOG_N} coefficients to b64), launches {used}; row 0's "
        "eval equals oracle.poly_eval")

    workers = {u: Worker(srs) for u in range(m)}
    times = {}
    challenge, responses, rewards, times["local"] = coordinator_round(
        coord, trt.LocalTransport(workers), "LocalTransport round")
    check((rewards > 0).all(), f"LocalTransport round: rewards {rewards}")
    reward_ms = []
    for r in responses:
        t0 = time.perf_counter()
        coord.reward(challenge, r)
        reward_ms.append((time.perf_counter() - t0) * 1e3)
    say(f"[round] run_round via LocalTransport: {times['local']:.3f} s, "
        f"{m} responses with commitment and proof, rewards "
        f"{float(rewards.min()):.4f}..{float(rewards.max()):.4f} (all > 0); "
        f"reward (host pairing) median {statistics.median(reward_ms):.2f} "
        "ms")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg, a_int, b_int = coord.aggregate_responses(challenge, responses)
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    check(coord.verify_aggregated(agg, a_int, b_int),
          "aggregate_responses: verify_aggregated False")
    say(f"[round] aggregate_responses on the complete set: {t_agg * 1e3:.1f} "
        "ms; verify_aggregated True")

    server = trt.WorkerServer(Worker(srs), port=0).start()
    try:
        _, _, rewards, times["http"] = coordinator_round(
            coord, trt.HttpTransport({u: server.url for u in range(m)}),
            "HttpTransport round")
    finally:
        server.stop()
    check((rewards > 0).all(), f"HttpTransport round: rewards {rewards}")
    say(f"[round] run_round via HttpTransport (a WorkerServer on "
        f"127.0.0.1, the card behind it): {times['http']:.3f} s, {m} "
        "responses with commitment and proof, every reward > 0")

    # a fresh coordinator: its scores start at 0, so the corrupt uid's
    # score after the round is its reward
    corrupt = m // 3
    mock_coord = trt.Coordinator(srs, trt.CoordinatorConfig(
        sample_size=m, timeout=COORDINATOR_TIMEOUT), hotkeys, seed=SEED + 1)
    _, _, rewards, times["mock"] = coordinator_round(
        mock_coord, trt.MockTransport(workers, min_time=0.1, max_time=0.5,
                                      seed=SEED, corrupt_uids=[corrupt]),
        "MockTransport round")
    check(int((rewards == 0).sum()) == 1
          and mock_coord.scores[corrupt] == 0.0
          and (np.delete(mock_coord.scores, corrupt) > 0).all(),
          f"MockTransport round: uid {corrupt} corrupt, rewards {rewards}, "
          f"scores {mock_coord.scores}")
    say(f"[round] run_round via MockTransport (uid {corrupt}'s proof "
        f"corrupted): {times['mock']:.3f} s; its reward exactly 0, the "
        f"other {m - 1} > 0")

    uids, weights = coord.set_weights()
    check(len(uids) == m and int(weights.max()) == 65535,
          f"set_weights: uids {uids}, weights {weights}")
    with tempfile.TemporaryDirectory() as state_dir:
        coord.config.state_dir = state_dir
        path = coord.save_state()
        fresh = trt.Coordinator(srs, trt.CoordinatorConfig(
            state_dir=state_dir), [])
        check(fresh.load_state() and fresh.step == coord.step == 2
              and fresh.hotkeys == hotkeys
              and np.array_equal(fresh.scores, coord.scores),
              "state.npz did not load back")
    say(f"[round] scores after 2 rounds {np.round(coord.scores, 4).tolist()}"
        f"; set_weights: {len(uids)} uids, max weight {int(weights.max())}; "
        f"{os.path.basename(path)} saved and loaded back (step "
        f"{fresh.step})")
    say("[round] coordinator timings: generate_challenge "
        f"{t_challenge * 1e3:.1f} ms; rounds "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f"; reward median {statistics.median(reward_ms):.2f} ms")


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


def run_cli(argv):
    """``python -m zkp_subnet_tpu_torch`` in this process, through the
    CLI's ``main``: (exit code, stdout lines, stderr, seconds, launches)."""
    before = dict(kernels.LAUNCHES)
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    return rc, out.getvalue().splitlines(), err.getvalue(), dt, used


def cli_files(tmp, shape):
    """The ``--setup-path``/``--precompute-path`` flags and the three files
    of one shape in ``tmp``."""
    scale, mscale = shape
    setup = os.path.join(tmp, f"setup_{scale}_{mscale}.npz")
    pre = os.path.join(tmp, f"precompute_{scale}_{mscale}.npz")
    flags = ["--setup-path", setup, "--precompute-path", pre,
             "--scale", str(scale), "--machines-scale", str(mscale)]
    return flags, (setup, pre, Srs._sidecar_path(pre))


def cli_setup(tmp, shape):
    flags, files = cli_files(tmp, shape)
    rc, out, err, dt, used = run_cli(["setup", *flags, "--generate-setup",
                                      "--generate-precompute"])
    m = 1 << shape[1]
    check(rc == 0 and out[-1].startswith("wrote "), f"setup {shape}: rc {rc}")
    check(f"worker slices {m}/{m}" in err,
          f"setup {shape}: not the streaming generate_to_disk")
    written = sum(os.path.getsize(f) for f in files)
    with open(files[0] + ".sha256") as f:
        listed = [line.split()[1] for line in f.read().splitlines()]
    check(listed == [os.path.basename(f) for f in files],
          f"setup {shape}: manifest lists {listed}")
    return flags, files, dt, written, used


def cli_check(flags, label, want_rc=0):
    rc, out, _, dt, _ = run_cli(["check", *flags[:4]])
    fails = [line for line in out if line.startswith("  FAIL")]
    passes = [line for line in out if line.startswith("  PASS")]
    check(rc == want_rc, f"{label}: check returned {rc}, not {want_rc}: "
          f"{fails}")
    return passes, fails, dt


class Timed:
    """Wraps methods of classes (or functions of modules) with a clock for
    the duration of a ``with``: ``seconds[name]`` sums the calls to
    ``name`` (for a coroutine, from its start to its end), ``calls`` lists
    (name, seconds) in the order the calls ended."""

    def __init__(self, **targets):
        self.targets = targets
        self.seconds = {name: 0.0 for name in targets}
        self.calls = []
        self.saved = []

    def _clock(self, name, fn):
        def stop(t0):
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.seconds[name] += dt
            self.calls.append((name, dt))

        if inspect.iscoroutinefunction(fn):
            async def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return await fn(*args, **kwargs)
                finally:
                    stop(t0)
        else:
            def timed(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    stop(t0)
        return timed

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._clock(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


_WORKER_LINE = re.compile(r"worker (\d+): reward=(\d+\.\d{3}) t=([\d.]+)s")


def cli_full_round(tmp, dev):
    """[cli] at the reference mainnet deployment: setup (the streaming
    generate_to_disk), check, aggregate over all 256 rows, and check of the
    sidecar with one byte flipped."""
    scale, mscale = CLI_FULL
    m = 1 << mscale
    side_bytes = m * (1 << (scale - mscale)) * 3 * FQ.L16 * 4
    free = shutil.disk_usage(tmp).free
    say(f"[cli] {tmp}: {free / 1e9:.2f} GB free; scale {scale} / "
        f"machines_scale {mscale} needs a {side_bytes / 1e9:.2f} GB sidecar")
    check(free >= side_bytes + CLI_DISK_SLACK,
          f"[cli] {free / 1e9:.2f} GB free in {tmp}: too little for the "
          f"{side_bytes / 1e9:.2f} GB sidecar of scale {scale} / "
          f"machines_scale {mscale}")

    flags, files, t_setup, written, used = cli_setup(tmp, CLI_FULL)
    check(os.path.getsize(files[2]) > side_bytes,
          "setup: the sidecar is smaller than the worker bases")
    say(f"[cli] setup --scale {scale} --machines-scale {mscale} "
        f"--generate-setup --generate-precompute: {t_setup:.1f} s (streaming "
        f"Srs.generate_to_disk, {m} worker slices, and the sha256 "
        f"manifest), {written / 1e9:.3f} GB written; launches {used}")

    passes, _, t_check = cli_check(flags, "check 24/8")
    say(f"[cli] check: {t_check:.1f} s, all {len(passes)} lines PASS")

    torch.cuda.reset_peak_memory_stats()
    responses = []
    get_rewards = trt.Coordinator.get_rewards

    def keep(coord, challenge, resps, *a, **k):
        responses.extend(resps)
        return get_rewards(coord, challenge, resps, *a, **k)
    trt.Coordinator.get_rewards = keep
    try:
        with Timed(challenge=(trt.Coordinator, "generate_challenge"),
                   rows=(trt.LocalTransport, "query"),
                   rewards=(trt.Coordinator, "get_rewards"),
                   aggregation=(trt.Coordinator, "aggregate_responses"),
                   verify=(trt.Coordinator, "verify_aggregated")) as clock:
            rc, out, err, t_round, used = run_cli(
                ["aggregate", *flags, "--timeout", str(CLI_FULL_TIMEOUT)])
    finally:
        trt.Coordinator.get_rewards = get_rewards
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check(rc == 0, f"aggregate: rc {rc}")
    rows = [_WORKER_LINE.fullmatch(line) for line in out[:m]]
    check(all(rows) and sorted(int(r[1]) for r in rows) == list(range(m)),
          "aggregate: not one reward line a worker")
    check(all(float(r[2]) > 0 for r in rows),
          f"aggregate: a reward of 0 in a round with no corrupt uid: "
          f"{[r[0] for r in rows if float(r[2]) <= 0][:4]}")
    check(len(responses) == m and all(r.commitment and r.proof and r.eval_
                                      for r in responses),
          "aggregate: a response lacks its commitment or proof")
    check(out[m] == "aggregated bivariate proof verifies: True",
          f"aggregate: {out[m]}")
    check(out[m + 1].startswith("weights: {0: "), "aggregate: no weights")
    slowest = max(r.process_time for r in responses)
    sec = clock.seconds
    say(f"[cli] aggregate --timeout {CLI_FULL_TIMEOUT:.0f}: {t_round:.1f} s "
        f"in all, {err.strip().splitlines()[0]}; {m} responses with "
        "commitment and proof, every reward > 0 "
        f"({min(float(r[2]) for r in rows):.3f}..{max(float(r[2]) for r in rows):.3f}); "
        "aggregated proof verifies: True")
    say(f"[cli] aggregate split: challenge {sec['challenge']:.2f} s, rows "
        f"{sec['rows']:.2f} s ({m / sec['rows']:.1f} rows/s over the round; "
        f"the largest process_time {slowest:.3f} s), rewards "
        f"{sec['rewards']:.2f} s, aggregation "
        f"{sec['aggregation'] * 1e3:.1f} ms + verify "
        f"{sec['verify'] * 1e3:.1f} ms; peak device memory {peak:.1f} MiB")
    say(f"[cli] aggregate launches {used}")
    # a row proved (the 256 and the warm-up's) is one MSM launch of each K2
    # kernel and one inverse of its own alpha
    check(used.get("fr_inv") == used.get("msm_buckets", 0) + 1
          and used.get("g1_msm_fixed") == 1
          and used.get("g1_fixed_table") == 1
          and "g1_scalar_mul" not in used,
          f"aggregate: not one fr_inv a row and one for the aggregation, "
          f"one g1_msm_fixed and one table, no ladder ({used})")

    # one byte of the sidecar flipped: check must fail on its digest
    with open(files[2], "r+b") as f:
        f.seek(os.path.getsize(files[2]) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    _, fails, t_bad = cli_check(flags, "check of a flipped byte", want_rc=1)
    check(fails == [f"  FAIL  sha256 {os.path.basename(files[2])}"],
          f"check of a flipped byte: {fails}")
    say(f"[cli] check with one byte of the sidecar flipped: rc 1 in "
        f"{t_bad:.1f} s ({fails[0].strip()})")
    # the byte back, for [mesh]
    with open(files[2], "r+b") as f:
        f.seek(os.path.getsize(files[2]) // 2)
        f.write(byte)
    return used


def cli_small(tmp, dev):
    """[cli] at the [round] shape: run twice on one state directory (the
    second resumes), serve in a thread with a SubnetClient over HTTP, and
    localnet over two ``serve`` processes."""
    scale, mscale = CLI_SMALL
    flags, files, t_setup, _, _ = cli_setup(tmp, CLI_SMALL)
    say(f"[cli] setup --scale {scale} --machines-scale {mscale}: "
        f"{t_setup:.1f} s")

    state = os.path.join(tmp, "state")
    argv = ["run", *flags, "--rounds", "3", "--neuron.epoch_length", "2",
            "--neuron.state_dir", state]
    steps = []
    for turn in range(2):
        rc, out, _, dt, _ = run_cli(argv)
        check(rc == 0, f"run {turn + 1}: rc {rc}")
        if turn:
            check(out[0] == f"resumed from {state}/state.npz at step "
                  f"{steps[0]}", f"run 2: {out[0]}")
        done = re.match(r"(\d+) forwards ok, step=(\d+),", out[-2])
        check(done and int(done[1]) == 3, f"run {turn + 1}: {out[-2]}")
        steps.append(int(done[2]))
        say(f"[cli] run --rounds 3 --neuron.epoch_length 2 ({turn + 1} of 2"
            f"): {dt:.1f} s; " + "; ".join(out))
    check(steps == [3, 6], f"run: steps {steps}, not [3, 6]")

    # serve, in a thread of this process; the client over HTTP
    served = []
    serve_forever = trt.WorkerServer.serve_forever

    def keep(server):
        served.append(server)
        serve_forever(server)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    trt.WorkerServer.serve_forever = keep
    result = {}
    # cli.main itself, not run_cli: its redirect of sys.stdout/stderr would
    # swallow the main thread's output for as long as the server runs
    thread = threading.Thread(target=lambda: result.update(
        rc=cli.main(["serve", *flags, "--port", str(port)])), daemon=True)
    try:
        thread.start()
        deadline = time.time() + 120
        while not served and time.time() < deadline and thread.is_alive():
            time.sleep(0.2)
        check(bool(served), "serve: no server came up")
        srs = Srs.load(*files[:2], lazy=True)
        coord = trt.Coordinator(srs, trt.CoordinatorConfig(timeout=60.0),
                                ["serve-0"])
        client = SubnetClient(coord, trt.HttpTransport(
            {0: f"http://127.0.0.1:{port}"}), sample_size=1)
        check(client.discover() == [0], "SubnetClient.discover: not [0]")
        row = [int(v) for v in np.random.default_rng(SEED).integers(
            0, 1 << 62, 1 << (scale - mscale))]
        x = (1 << 200) + 12345
        poly = enc.poly_to_b64(row)
        t0 = time.perf_counter()
        com = client.commit(poly, index=3)
        y, prf = client.open(poly, enc.fr_to_b64(x), index=3)
        t_client = time.perf_counter() - t0
        tau_x, tau_y = _trapdoor(None, None, 0)
        key = _lagrange_coeffs_at(tau_y, 1 << mscale)[3]
        selfcheck(Prove(index=3, poly=[], eval_=y, commitment=com,
                        proof=prf), row, x, False, tau=tau_x, key=key)
        check(client.verify(com, enc.fr_to_b64(x), y, prf, index=3),
              "SubnetClient.verify: False")
        check(not client.verify(com, enc.fr_to_b64(x), y, com, index=3),
              "SubnetClient.verify of a wrong proof: True")
    finally:
        for server in served:
            server._httpd.shutdown()
        thread.join(timeout=30)
        trt.WorkerServer.serve_forever = serve_forever
    check(result.get("rc") == 0, f"serve: rc {result.get('rc')}")
    say(f"[cli] serve on 127.0.0.1:{port} + SubnetClient over HttpTransport:"
        f" discover [0], commit and open of a 2^{scale - mscale} row as "
        f"worker 3 in {t_client:.2f} s, trapdoor self-check PASS, verify "
        "True (False for a wrong proof)")

    # localnet: python -m zkp_subnet_tpu_torch, a real process and its two
    # serve children
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "zkp_subnet_tpu_torch", "localnet", *flags,
         "--workers", "2", "--rounds", "1"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    check(proc.returncode == 0
          and tail[0].startswith("1/1 rounds ok over 2 worker processes"),
          f"localnet: rc {proc.returncode}: {tail[0]} "
          f"{proc.stderr.strip()[-2000:]}")
    say(f"[cli] localnet --workers 2 --rounds 1 (python -m "
        f"zkp_subnet_tpu_torch, two serve processes on the card): "
        f"{dt:.1f} s; {tail[0][:60]}")


def phase_cli(dev, tmp):
    """``python -m zkp_subnet_tpu_torch``'s commands in ``tmp``: scale 24/8
    setup, check and aggregate, then 20/4 run with a resume, serve with the
    client, and localnet. The SRS files of both shapes stay in ``tmp`` for
    [mesh]. Returns the launch counts of the commands run in this
    process."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    cli_full_round(tmp, dev)
    t_full = time.perf_counter() - t0
    cli_small(tmp, dev)
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        if k not in CLI_IDLE:
            check(v > 0, f"the [cli] path launched {k} {v} times")
    say(f"[cli] launches {launches}")
    say(f"[cli] wall {time.perf_counter() - t0:.1f} s: scale 24/8 "
        f"{t_full:.1f} s, scale 20/4 {time.perf_counter() - t0 - t_full:.1f}"
        " s")
    return launches


def check_default_request(used, label, n):
    """One request at a default row of n coefficients: the opening as
    [main]'s (five K3 launches, at most seven K3-family launches), its two
    MSMs as one ladder launch (the group form) and one tree of at most
    log2(n) g1_add launches for the sums; no K2 kernel, no K1 double."""
    for k in ("fr_inv",) + OPENING:
        check(used[k] == 1, f"{label}: {used[k]} {k} launches, not 1")
    check(used["g1_scalar_mul"] == 1 and kernels.ladder_grouped(2 * n),
          f"{label}: {used['g1_scalar_mul']} ladder launches, not one of "
          "the group form")
    tree = n.bit_length() - 1
    check(0 < used["g1_add"] <= tree,
          f"{label}: {used['g1_add']} g1_add launches, not 1..{tree}")
    for k in ("msm_buckets", "msm_reduce", "msm_combine", "fr_add",
              "g1_double"):
        check(used[k] == 0, f"{label}: {used[k]} {k} launches, not 0")
    k3 = sum(used[k] for k in K3_FAMILY)
    check(k3 <= 7, f"{label}: {k3} K3-family launches, more than 7")


def phase_default(rng, dev, tmp):
    """[default]: the configuration a user gets with no flags, scale 18 and
    machines_scale 8 (256 workers x 1024 coefficients), no cut. ``setup``
    and ``check`` with the CLI's defaults (./setup.npz, ./precompute.npz)
    in a directory of its own; a ``Worker`` over worker DEFAULT_WORKER's
    slice serves WARM_REQUESTS + 1 commit+open requests and a commit-only
    one (the trapdoor self-check, the pairing verify, one ladder launch and
    one tree of g1_add a request), their median and the host split; then
    ``parallel.launch.main`` with the launcher's defaults over those files
    as one NCCL rank (``launch_rounds``, ``check_launch_proof``: one ladder
    over 2^19 products and one tree of 10 g1_add a prove). Returns its
    launch counts."""
    scale, mscale = DEFAULT_SHAPE
    kernels.reset_launches()
    t0 = time.perf_counter()
    work = os.path.join(tmp, "default")
    os.makedirs(work)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        rc, out, err, t_setup, setup_used = run_cli(
            ["setup", "--generate-setup", "--generate-precompute"])
        check(rc == 0 and out[-1] == "wrote ./setup.npz and "
              f"./precompute.npz (scale={scale}, machines_scale={mscale})",
              f"[default] setup: rc {rc}, {out[-1:]}, {err[-2000:]}")
        passes, _, t_check = cli_check([], "[default] check")
    finally:
        os.chdir(cwd)
    check(passes, "[default] check printed no PASS line")
    setup_p = os.path.join(work, "setup.npz")
    pre_p = os.path.join(work, "precompute.npz")
    say(f"[default] setup with the CLI's defaults (scale {scale}, "
        f"machines_scale {mscale}: ./setup.npz, ./precompute.npz; "
        f"{(os.path.getsize(setup_p) + os.path.getsize(pre_p)) / 1e6:.1f} MB"
        f" written): {t_setup:.2f} s, launches {setup_used}; check: all "
        f"{len(passes)} lines PASS in {t_check:.2f} s")

    srs = Srs.load(setup_p, pre_p)
    n = srs.row_size
    check((srs.scale, srs.machines_scale, n) == (scale, mscale, 1024),
          f"[default] the files hold {srs.scale}/{srs.machines_scale}")
    worker = Worker(srs)
    tau_x, tau_y = _trapdoor(None, None, 0)     # setup's default seed 0
    key = _lagrange_coeffs_at(tau_y, srs.machines)[DEFAULT_WORKER]

    def request(commit_only):
        limbs = random_scalar_limbs(rng, n)
        x_int = None if commit_only else \
            int.from_bytes(rng.bytes(32), "little") % o.R
        syn = Prove(index=DEFAULT_WORKER, poly=enc.limbs_to_b64(limbs),
                    alpha=None if commit_only else enc.fr_to_b64(x_int))
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        resp = worker.forward(syn)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        used = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kind = "commit-only" if commit_only else "commit+open"
        label = f"[default] {kind} request"
        selfcheck(resp, limbs_to_ints(limbs), x_int, commit_only,
                  tau=tau_x, key=key)
        if not commit_only:
            check(worker.worker_verify(DEFAULT_WORKER, resp.proof,
                                       resp.alpha, resp.eval_,
                                       resp.commitment),
                  f"{label}: worker_verify rejected the proof")
        check_default_request(used, label, n)
        return dt, {k: v for k, v in used.items() if v}

    first, used = request(False)
    times = [request(False)[0] for _ in range(WARM_REQUESTS)]
    t_commit, used_commit = request(True)
    med = statistics.median(times) * 1e3
    say(f"[default] worker {DEFAULT_WORKER}, {n} coefficients: every "
        f"request trapdoor self-check PASS, pairing verify PASS; first "
        f"{first * 1e3:.2f} ms, warm commit+open median {med:.2f} ms over "
        f"{len(times)} ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms), "
        f"commit-only {t_commit * 1e3:.2f} ms; a request's launches {used} "
        f"(commit-only {used_commit}): one ladder of {2 * n} products (the "
        "group form), one tree of g1_add, no K2")
    host_split(worker, rng, "[default]", DEFAULT_WORKER)
    del worker, srs

    for path in (setup_p, pre_p):
        os.symlink(os.path.basename(path), os.path.join(
            work, os.path.basename(path).replace(".npz",
                                                 f"_{scale}_{mscale}.npz")))
    kept = launch_rounds(dev, work, DEFAULT_SHAPE, "[default]", [],
                         ladders=1)
    check_launch_proof(kept, work, DEFAULT_SHAPE, "[default]")
    del kept
    launches = dict(kernels.LAUNCHES)
    for k in ("g1_scalar_mul", "g1_add", "fr_inv", "g1_msm_fixed",
              "g1_fixed_table") + OPENING:
        check(launches[k] > 0, f"the [default] path never launched {k}")
    say(f"[default] launches {launches}")
    say(f"[default] wall {time.perf_counter() - t0:.1f} s")
    return launches


class LogLines(logging.Handler):
    """The messages of one logger at INFO, for the length of a ``with``."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level)


def launch_rounds(dev, srs_dir, shape, label, flags, ladders):
    """``parallel.launch.main`` over the files of ``shape`` in ``srs_dir``
    (``setup_{scale}_{machines}.npz``), one NCCL rank, MESH_ROUNDS rounds,
    with ``flags`` beside ``--srs-dir``, ``--rounds`` and ``--seed``; each
    round split by stage. Checks the launches (a prove: one inverse of
    alpha, the aggregation's inverse and one ``g1_msm_fixed``, ``ladders``
    ladder launches; the keys' table once, in ``shard_srs``; the local
    commit+open of all rows one launch of ``fr_inv`` and of each opening
    kernel, and where it runs the naive MSM one ladder, no K2 kernel and
    one tree of log2(row) ``g1_add``). Returns the last round's
    ``prove_gathered`` arguments and output."""
    scale, mscale = shape
    m = 1 << mscale
    setup = default_paths(srs_dir, scale, mscale)[0]
    kept, local_launches = [], []
    prove_gathered, commit_open = par.prove_gathered, par.commit_open

    def keep(*args):
        out = prove_gathered(*args)
        kept[:] = [args, out]
        return out

    def count_local(*args):
        before = dict(kernels.LAUNCHES)
        out = commit_open(*args)
        local_launches.append({k: v - before[k] for k, v in
                               kernels.LAUNCHES.items() if v != before[k]})
        return out
    par.prove_gathered, par.commit_open = keep, count_local
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated(dev) / 2**20
    before = dict(kernels.LAUNCHES)
    try:
        with LogLines("zkp_subnet_tpu_torch.launch") as log, Timed(
                shard=(par, "shard_srs"), draw=(pianist, "_uniform_fr"),
                fft=(par, "fft"), local=(par, "commit_open"),
                gather=(par, "gather"),
                aggregation=(pianist, "aggregate_core"),
                prove=(par, "prove")) as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = launch.main([*flags, "--srs-dir", srs_dir, "--rounds",
                              str(MESH_ROUNDS), "--seed", str(SEED)])
            t_launch = time.perf_counter() - t0
    finally:
        par.prove_gathered, par.commit_open = prove_gathered, commit_open
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}
    check(rc == 0, f"{label} launch.main: rc {rc}")
    # a prove inverts alpha once for its rows and aggregates with one
    # inverse and one g1_msm_fixed; shard_srs builds the keys' table once
    check(used.get("fr_inv") == 2 * MESH_ROUNDS
          and used.get("g1_msm_fixed") == MESH_ROUNDS
          and used.get("g1_fixed_table") == 1
          and used.get("g1_scalar_mul", 0) == ladders * MESH_ROUNDS,
          f"{label} launch.main: not 2 fr_inv, one g1_msm_fixed and "
          f"{ladders} ladder a round and the table once ({used})")
    # the local step opens all its rows at alpha in one launch of each
    # opening kernel, with alpha inverted once; a naive MSM's sums are one
    # tree of log2(row) g1_add
    tree = (scale - mscale) if ladders else None
    check(len(local_launches) == MESH_ROUNDS and all(
        all(u.get(k) == 1 for k in ("fr_inv",) + OPENING)
        and (tree is None or (u.get("g1_scalar_mul") == 1
                              and u.get("g1_add", 0) <= tree
                              and not {"msm_buckets", "msm_reduce",
                                       "msm_combine"} & set(u)))
        for u in local_launches),
        f"{label} launch.main: a local commit+open not one launch of fr_inv "
        f"and of each opening kernel" + ("" if tree is None else
                                         f", one ladder and <= {tree} "
                                         "g1_add, no K2")
        + f": {local_launches}")
    check(f"loaded SRS from {setup}" in log.lines,
          f"{label} launch.main did not load {setup}: {log.lines}")
    mesh_line = [x for x in log.lines if x.startswith("mesh ")]
    check(mesh_line and mesh_line[0].endswith("backend nccl"),
          f"{label} launch.main: not one NCCL rank: {mesh_line}")
    check([x for x in log.lines if x.endswith("sub-proofs aggregated")]
          == [f"round {r}: {m} sub-proofs aggregated"
              for r in range(MESH_ROUNDS)],
          f"{label} launch.main: {log.lines}")
    say(f"{label} parallel.launch.main {' '.join(flags)} --rounds "
        f"{MESH_ROUNDS} (scale {scale}, machines_scale {mscale}): "
        f"{t_launch:.1f} s in all; " + "; ".join(log.lines[:2])
        + f"; shard_srs {clock.seconds['shard']:.2f} s ({m} worker slices "
        "from the files to the card)")
    # the stages of each round, in call order: the draws, the X inverse
    # NTT, the local commit+open, the gather, the aggregation
    rounds, cur = [], None
    for name, dt in clock.calls:
        if name == "draw" and (cur is None or "prove" in cur):
            cur = {}
            rounds.append(cur)
        if cur is not None:
            cur[name] = cur.get(name, 0.0) + dt
    check(len(rounds) == MESH_ROUNDS and all("prove" in r for r in rounds),
          f"{label} {len(rounds)} rounds timed, not {MESH_ROUNDS}")
    for i, r in enumerate(rounds):
        say(f"{label} round {i}: draw {r['draw'] * 1e3:.1f} ms, X inverse "
            f"NTT of {m} x 2^{scale - mscale} {r['fft'] * 1e3:.2f} ms, local "
            f"commit+open of {m} rows {r['local']:.3f} s, gather "
            f"{r['gather'] * 1e3:.2f} ms, aggregation "
            f"{r['aggregation'] * 1e3:.1f} ms; prove {r['prove']:.3f} s = "
            f"{m / r['prove']:.1f} rows/s ({m / (r['fft'] + r['prove']):.1f}"
            " rows/s with the NTT)")
    say(f"{label} peak device memory {peak:.1f} MiB ({held:.1f} MiB of it "
        f"held before the launch); launch.main's launches "
        f"{used}; a prove's local commit+open of {m} rows launches "
        f"{local_launches[-1]}")
    return kept


def check_launch_proof(kept, srs_dir, shape, label):
    """The last round's aggregated proof verifies (and not once tampered);
    MESH_SAMPLED workers pass ``worker_verify`` and the trapdoor self-check
    (the CLI's ``setup`` with seed 0) and equal
    ``pianist.worker_commit``/``worker_open`` limb for limb."""
    scale, mscale = shape
    m = 1 << mscale
    (_, coeff, alpha, beta, _), (out, (_, evals, _)) = kept
    srs = Srs.load(*default_paths(srs_dir, scale, mscale), lazy=True)
    a_int, b_int = FR.decode(alpha)[0], FR.decode(beta[0])[0]
    agg = pianist.AggregatedProof(
        commitment=out.commitment[0], proof_x=out.proof_x[0],
        evals=evals[0], commitment_y=out.commitment_y[0],
        proof_y=out.proof_y[0], value=out.value[0])
    check(pianist.verify_aggregated(srs, agg, a_int, b_int),
          f"{label} the distributed proof does not verify")
    bad = dataclasses.replace(agg, proof_x=agg.commitment)
    check(not pianist.verify_aggregated(srs, bad, a_int, b_int),
          f"{label} a tampered distributed proof verifies")
    tau_x, tau_y = _trapdoor(None, None, 0)      # the CLI's setup: seed 0
    keys = _lagrange_coeffs_at(tau_y, m)
    inner = np.random.default_rng(SEED).permutation(np.arange(1, m - 1))
    sampled = sorted({0, m - 1, *inner[:MESH_SAMPLED - 2].tolist()})
    for i in sampled:
        com, prf, y = out.commitments[0, i], out.proofs[0, i], evals[0, i]
        row = coeff[0, i]
        w_com = pianist.worker_commit(srs, i, row)
        w_y, w_prf = pianist.worker_open(srs, i, row, alpha)
        check(torch.equal(com, w_com) and torch.equal(prf, w_prf)
              and torch.equal(y, w_y),
              f"{label} worker {i}: not the limbs of worker_commit/open")
        com_pt, prf_pt = cv.g1_decode(com)[0], cv.g1_decode(prf)[0]
        y_int = FR.decode(y)[0]
        check(pianist.worker_verify(srs, i, prf_pt, a_int, y_int, com_pt),
              f"{label} worker {i}: worker_verify False")
        selfcheck(Prove(index=i, poly=[], eval_=enc.fr_to_b64(y_int),
                        commitment=enc.g1_to_b64(com_pt),
                        proof=enc.g1_to_b64(prf_pt)),
                  FR.decode(row), a_int, False, tau=tau_x, key=keys[i])
    say(f"{label} the last round's aggregated proof verifies: True (False "
        f"with W swapped for C); workers {sampled}: worker_verify and "
        "trapdoor self-check PASS, limbs equal to pianist.worker_commit/"
        "worker_open")


def mesh_deployment(dev, tmp):
    """[mesh] at the mainnet deployment: ``parallel.launch.main`` over the
    24/8 files [cli] wrote (``launch_rounds``, ``check_launch_proof``),
    then the Y-axis NTT's round trip on the last round's rows."""
    scale, mscale = CLI_FULL
    m = 1 << mscale
    kept = launch_rounds(dev, tmp, CLI_FULL, "[mesh]",
                         ["--scale", str(scale), "--machines-scale",
                          str(mscale)], ladders=0)
    check_launch_proof(kept, tmp, CLI_FULL, "[mesh]")
    coeff = kept[0][1]
    mesh = par.make_mesh()
    backend = torch.distributed.get_backend()
    check(backend == "nccl", f"[mesh] backend {backend}, not nccl")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = par.fft(coeff, mesh, left=False)
    back = par.fft(cols, mesh, left=False, inverse=True)
    torch.cuda.synchronize()
    t_y = time.perf_counter() - t0
    check(torch.equal(back, coeff), "[mesh] the Y-axis NTT does not "
          "round-trip")
    say(f"[mesh] dist.get_backend(): {backend}; fft(left=False) forward + "
        f"inverse of the {m} x 2^{scale - mscale} block: {t_y * 1e3:.1f} ms,"
        " equal to the block")
    return mesh


def mesh_transport_rounds(mesh, dev, tmp):
    """[mesh] at the [round] shape (20/4: 16 rows of 2^16), over [cli]'s
    files: ``Coordinator.run(MeshTransport, rounds=2)``, every reward > 0
    and one ``process_time`` a round; a second transport with one corrupt
    uid scores exactly one 0."""
    (setup, pre, _) = cli_files(tmp, CLI_SMALL)[1]
    srs = Srs.load(setup, pre, lazy=True)
    m = srs.machines
    sharded = par.shard_srs(srs, mesh)
    transport = trt.MeshTransport(sharded, mesh)
    t_warm = transport.warmup()
    hotkeys = [f"mesh{i}" for i in range(m)]
    coord = trt.Coordinator(srs, trt.CoordinatorConfig(
        sample_size=m, timeout=COORDINATOR_TIMEOUT, epoch_length=1,
        state_dir=os.path.join(tmp, "mesh_state")), hotkeys, seed=SEED)
    rounds = []
    forward = coord.forward

    async def keep(transport, timeout=None):
        t0 = time.perf_counter()
        got = await forward(transport, timeout)
        rounds.append((got, time.perf_counter() - t0))
        return got
    coord.forward = keep
    ok = asyncio.run(coord.run(transport, rounds=2))
    check(ok == 2 and len(rounds) == 2, f"[mesh] Coordinator.run: {ok} ok")
    for i, ((_, responses, rewards), dt) in enumerate(rounds):
        times = {r.process_time for r in responses}
        check(len(responses) == m and all(r.commitment and r.proof
                                          for r in responses),
              f"[mesh] MeshTransport round {i}: a response lacks its proof")
        check((rewards > 0).all(), f"[mesh] round {i}: rewards {rewards}")
        check(len(times) == 1, f"[mesh] round {i}: process_times {times}")
        say(f"[mesh] Coordinator.run via MeshTransport, round {i + 1} of 2: "
            f"{dt:.3f} s; {m} responses, every reward > 0 "
            f"({float(rewards.min()):.4f}..{float(rewards.max()):.4f}), one "
            f"process_time {times.pop():.3f} s for all")
    uids, weights = coord.set_weights()
    check(int(weights.max()) == 65535, f"[mesh] weights {weights}")

    corrupt = m // 3
    bad = trt.Coordinator(srs, trt.CoordinatorConfig(
        sample_size=m, timeout=COORDINATOR_TIMEOUT), hotkeys, seed=SEED + 1)
    _, responses, rewards = bad.run_round(trt.MeshTransport(
        sharded, mesh, corrupt_uids=[corrupt]))
    check(int((rewards == 0).sum()) == 1 and bad.scores[corrupt] == 0.0
          and (np.delete(bad.scores, corrupt) > 0).all()
          and len({r.process_time for r in responses}) == 1,
          f"[mesh] corrupt uid {corrupt}: rewards {rewards}")
    say(f"[mesh] MeshTransport at scale {srs.scale} / machines_scale "
        f"{srs.machines_scale}: warmup {t_warm:.2f} s; set_weights max "
        f"{int(weights.max())}; with uid {corrupt}'s proof corrupted its "
        f"reward exactly 0, the other {m - 1} > 0, one process_time")


def phase_mesh(dev, tmp):
    """[mesh]: the multi-device path on one NCCL rank (see the module
    docstring). Returns its launch counts."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    mesh = mesh_deployment(dev, tmp)
    try:
        mesh_transport_rounds(mesh, dev, tmp)
        t1 = time.perf_counter()
        dryrun_multichip(1)
        say(f"[mesh] dryrun_multichip(1) on the card: "
            f"{time.perf_counter() - t1:.1f} s (NTT both ways, a verified "
            "prove, a scored round)")
    finally:
        torch.distributed.destroy_process_group()
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        if k not in CLI_IDLE:
            check(v > 0, f"the [mesh] path launched {k} {v} times")
    say(f"[mesh] launches {launches}; fr_inv {launches['fr_inv']} in all")
    say(f"[mesh] wall {time.perf_counter() - t0:.1f} s")
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
    usage = kernels.ptxas_usage(info["log"])
    say(f"[build] nvcc sm_90a, {len(kernels.SOURCES)} sources: "
        f"{info['seconds']:.1f} s")
    for fn, u in usage.items():
        say(f"[build]   {fn}: {u['registers']} registers, {u['stack']} B "
            f"stack, {u['spill_stores']} B spill stores, "
            f"{u['spill_loads']} B spill loads")

    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = INT32_LANES_PER_SM * sms * sm_mhz * 1e6
    say(f"[device] bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s; integer rate "
        f"{INT32_LANES_PER_SM} lanes x {sms} SMs x {sm_mhz:.0f} MHz = "
        f"{int_ops_per_s / 1e12:.2f} T 32-bit operations/s")

    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zkp_cli_")
    try:
        res = phase_kernels(rng, dev, int_ops_per_s)
        main_launches, setup_launches, request_launches = phase_main_path(
            rng, dev)
        round_launches = phase_round(rng, dev)
        phase_aggregate_wide(rng, dev)
        phase_ntt_cells(dev)
        cli_launches = phase_cli(dev, tmp)
        default_launches = phase_default(rng, dev, tmp)
        mesh_launches = phase_mesh(dev, tmp)
        phase_device_times(res, dev)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[done] all phases in {time.perf_counter() - t_start:.1f} s after "
        "the build")

    # launches: the paths' counts added, each path counted from 0
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": (main_launches[k] + round_launches[k]
                           + cli_launches[k] + default_launches[k]
                           + mesh_launches[k]),
              "launches_main": main_launches[k],
              "launches_main_setup": setup_launches.get(k, 0),
              "launches_main_request": request_launches[k],
              "launches_round": round_launches[k],
              "launches_cli": cli_launches[k],
              "launches_default": default_launches[k],
              "launches_mesh": mesh_launches[k],
              "max_abs_err": res[k]["max_abs_err"],
              "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"],
              "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"],
              "library_ms": None, "device_ms": res[k]["device_ms"],
              "registers": usage[KERNEL_FUNCTIONS[k]]["registers"],
              "profiler_ms": res[k]["profiler_ms"],
              "other_ms": res[k].get("other_ms"),
              "other_bound_ms": res[k].get("other_bound_ms"),
              "other_plain_ms": res[k].get("other_plain_ms")}
             for k, (src, rep) in KERNELS.items()]
    say(json.dumps({"kernels": table}))
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
