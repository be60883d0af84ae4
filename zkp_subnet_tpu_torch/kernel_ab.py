"""K1 ``g1_add``/``g1_double``/``g1_scalar_mul``, K2 ``msm_buckets``, the
Pianist aggregation's two Lagrange-Y MSMs, K3 ``fr_inv`` and the opening's
K3 kernels of several checkouts of this repository, timed in turns on one
card on the same inputs.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m zkp_subnet_tpu_torch.kernel_ab DIR [DIR ...]

Each DIR is the root of a checkout: an earlier commit unpacked with ``git
archive``, or a copy whose sources were edited to try one design choice.
Each is driven through its own package, in a process of its own: its
``kernels.build()`` compiles its sources into its own ``build/`` (all
checkouts at once), and its wrappers ``g1_add``, ``g1_double`` (at 2^16,
2^20 and 16 points), ``msm_buckets(points, *msm.bucket_runs(scalars,
groups))``, ``msm_reduce`` of the uniform scalars' 512 rows of 256
buckets, ``fr_inv`` (of
one random element, and of 16 with 0, 1 and r − 1 among them) and, where
the checkout has it, the ladder ``g1_scalar_mul`` (``LADDER_POINTS``: 16
points, a default request's 2 × 1024, 2 × 2048, 2^16 and a default
prove's 2^19, scalars below r; where the checkout has two forms, each at
``LADDER_FORMS``) and beside it a request's naive MSM (``msm_auto_many``)
and K2's ``msm_many`` at 2 × 1024 and 2 × 2048 are timed; and the
aggregation's two MSMs
over 16, 256 and 1024 keys, as the checkout's aggregation runs them:
``g1_msm_fixed`` over the keys' window table (built untimed) where it has
one, else a ladder and a ``g1_sum`` tree an MSM (``msm.msm_naive``), and
not at all where its ``g1_msm_fixed`` refuses that many keys (before the
tree of launches, past 512); the keys' table ``g1_fixed_table`` at 256 and
1024 keys, compared by its bases at every 8 bits, [2^(8v)]P_i, which every
layout holds; and
the opening's ``fr_powers`` and ``fr_open_quotient`` at one row of 2^16 and
at 256 such rows at one point, and ``fr_power_tables``, as the checkout
runs them (``_opening_fns``); the scan's first pass ``fr_suffix_scan`` at
one row of 2^16, at the 256 rows laid end to end and at a default row of
1024 (with the quotient and the opening there), and the challenge's
``fr_eval_rows`` at 16 and at 256 of those rows at one point and at one
row at 16 points, and the whole opening of one row and of the 256
(``_scan_eval_fns``). The inputs are made once, from a seed, by
this checkout's package: 2^16 points with Z ≠ 1, the scalars of two MSMs
of 2^16 points (8 point groups: 512 rows of 8192 entries, the main path's
shape), uniform, and all equal to 1, and the opening's row and its
batch's factors. Device ms: CUDA events around the replay of a CUDA graph of several
launches. Every checkout is timed twice, in the order given and then in
the reverse order. Its outputs must equal those of the first checkout
that has the kernel: the K1 kernels but the ladder and the inverses limb
for limb, the ladder, the bucket sums and the MSMs as points; and before any
number, each checkout's aggregation MSMs must equal the oracle's Σ
k_i·P_i (the keys' discrete logs are known). A scan's local sums and
totals depend on the checkout's tile: they are held limb for limb to the
checkout's own plain version, and compared across checkouts by the
opening ``fr_open_quotient`` makes of them. ``--only PREFIX ...`` times
only the functions whose names start so (``fr_`` for K3). Then, for each
checkout, the registers and spills of the kernels (``KERNELS``, from
``-Xptxas -v``) and the SASS
instruction mix of ``g1_add_kernel`` and ``g1_double_kernel`` (``cuobjdump
-sass``; a static count, which for a kernel without loops is what each
thread executes). The last
lines are the card (``nvidia-smi`` name and power limit) and one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

LOG_N = 16
SEED = 20261016
#: launches a graph replays: (g1_add, g1_double), msm_buckets, the ladder,
#: the opening's kernels over the batch
REPS_POINT, REPS_BUCKETS, REPS_LADDER, REPS_BATCH = 100, 5, 2, 2
#: the double's shapes (label, points, launches a graph replays): one wave
#: of the card (2^16), several (2^20) and the launch floor (16)
DOUBLE_POINTS = (("2^16 points", 1 << 16, REPS_POINT),
                 ("2^20 points", 1 << 20, 20), ("16 points", 16, REPS_POINT))
#: the kernels whose SASS instruction mix the report prints
SASS_KERNELS = ("g1_add_kernel", "g1_double_kernel")
#: the ladder's shapes (label, points, rows of bases): 16 points (the
#: aggregation's before g1_msm_fixed), a default request's two MSMs of 1024
#: and two of 2048 (the most a naive MSM takes), 2^16 (chip_smoke.py's SRS
#: row), a one-rank prove's 2^19 at 18/8; and the points at which each form
#: of a checkout that has two is timed (around their crossover)
LADDER_POINTS = (("16 points", 16, 1), ("2 x 1024", 2048, 2),
                 ("2 x 2048", 4096, 2), ("2^16 points", 1 << 16, 1),
                 ("2^19 points", 1 << 19, 1), ("2^13 points", 1 << 13, 1),
                 ("2^14 points", 1 << 14, 1), ("2^15 points", 1 << 15, 1))
LADDER_FORMS = (2048, 4096, 1 << 13, 1 << 14, 1 << 15)
#: the aggregation's MSMs over the keys' table, and the table
REPS_FIXED, REPS_TABLE = 10, 2
#: the aggregation's keys: [round]'s 16, the mainnet's 256, machines_scale
#: 10's 1024
FIXED_KEYS = (16, 256, 1024)
#: rows of the opening's batch (a prove's 256 workers at 24/8), and the
#: rows a scan of it is held to its plain version on
BATCH = 256
BATCH_SAMPLED = (0, 1, 128, 255)
#: a default configuration's row (18/8: 1024 coefficients a worker)
DEFAULT_ROW = 1024
#: launches a graph replays: the scan and the evaluation over the batch,
#: the evaluation of 16 rows and of one row at 16 points
REPS_SCAN, REPS_EVAL = 5, 20
KERNELS = ("g1_add_kernel", "g1_double_kernel", "msm_buckets_kernel",
           "g1_scalar_mul_kernel", "g1_scalar_mul_group_kernel",
           "fr_inv_kernel", "g1_msm_fixed_kernel",
           "g1_msm_fixed_sum_kernel", "g1_fixed_table_kernel",
           "g1_fixed_multiples_kernel", "fr_power_tables_kernel",
           "fr_powers_kernel", "fr_suffix_scan_kernel",
           "fr_open_quotient_kernel", "fr_eval_partial_kernel",
           "fr_eval_sum_kernel")


def _graph_ms(fn, reps: int) -> float:
    """ms a launch of ``fn`` by CUDA-graph replay of ``reps`` launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _same_points(kernels, a, b) -> bool:
    """(..., 3, 12) a and b are the same projective points: X1·Z2 = X2·Z1,
    Y1·Z2 = Y2·Z1 (K4 ``fq_mul``) and infinity alike."""
    import torch

    a, b = a.reshape(-1, 3, 12), b.reshape(-1, 3, 12)
    za, zb = a[:, 2].contiguous(), b[:, 2].contiguous()
    for c in (0, 1):
        if not torch.equal(kernels.fq_mul(a[:, c].contiguous(), zb),
                           kernels.fq_mul(b[:, c].contiguous(), za)):
            return False
    return torch.equal((za == 0).all(-1), (zb == 0).all(-1))


def child_build() -> dict:
    """In a checkout's process: build its kernels."""
    from zkp_subnet_tpu_torch.ops import kernels

    info = kernels.build(force=True)
    return {"seconds": info["seconds"], "log": info["log"],
            "lib": kernels.LIB_PATH}


def child_time(inputs: str, reference: str, *only: str) -> dict:
    """In a checkout's process: time its kernels on the inputs (those whose
    names start with one of ``only``, where given), and hold the outputs
    to ``reference`` (written here if it does not exist)."""
    import torch
    from zkp_subnet_tpu_torch.ops import kernels
    from zkp_subnet_tpu_torch.ops import msm as tmsm

    dev = torch.device("cuda", 0)
    data = torch.load(inputs)
    p, q = data["p"].to(dev), data["q"].to(dev)
    fns = {"g1_add": (lambda: kernels.g1_add(p, q), REPS_POINT)}
    for label, n, reps in DOUBLE_POINTS:
        pts = p[:n] if n <= p.shape[0] else p.repeat(n // p.shape[0], 1, 1)
        fns[f"g1_double {label}"] = (
            lambda pts=pts.contiguous(): kernels.g1_double(pts), reps)
    for label, scalars in data["scalars"].items():
        scalars = scalars.to(dev)
        runs = tmsm.bucket_runs(scalars, tmsm._groups(scalars.shape[1]))
        fns[f"msm_buckets {label}"] = (
            lambda runs=runs: kernels.msm_buckets(p, *runs), REPS_BUCKETS)
        if label == "uniform":
            bk = kernels.msm_buckets(p, *runs)
            fns["msm_reduce 512 x 256"] = (
                lambda bk=bk: kernels.msm_reduce(bk), REPS_BUCKETS)
    if hasattr(kernels, "g1_scalar_mul"):
        fns.update(_ladder_fns(kernels, tmsm, p, data["ladder"].to(dev)))
    for n, x in ((1, data["fr"][3:4]), (16, data["fr"])):
        x = x.to(dev)
        fns[f"fr_inv {n}"] = (lambda x=x: kernels.fr_inv(x), REPS_POINT)
    fixed = _fixed_fns(kernels, tmsm, p, data["scalars"]["uniform"].to(dev))
    fns.update(fixed)
    fns.update(_opening_fns(kernels, data, dev))
    fns.update(_scan_eval_fns(kernels, data, dev))
    if only:
        fns = {k: v for k, v in fns.items() if k.startswith(only)}
    # a function's output, or where it has a view (fns[name][2]) what the
    # view makes of it, is compared across checkouts
    outs = {name: _flat(view[0](fn()) if view else fn())
            for name, (fn, _, *view) in fns.items()}
    torch.cuda.synchronize()
    _oracle_check(outs, data["scalars"]["uniform"], p)
    ms = {name: _graph_ms(fn, reps) for name, (fn, reps, *_) in fns.items()}
    # the first checkout that has a kernel writes its reference output
    ref = torch.load(reference) if os.path.exists(reference) else {}
    missing = {k: v.cpu() for k, v in outs.items() if k not in ref}
    if missing:
        ref.update(missing)
        torch.save(ref, reference)
    ref = {k: v.to(dev) for k, v in ref.items()}
    # the ladder's forms give other projective Z than the binary ladder
    equal = {k: (torch.equal(v, ref[k]) if k.startswith(("g1_", "fr_"))
                 and not k.startswith("g1_scalar_mul")
                 else _same_points(kernels, v, ref[k]))
             for k, v in outs.items()}
    return {"ms": ms, "equal": equal, "package": kernels.CSRC}


def _ladder_fns(kernels, tmsm, p, scalars) -> dict:
    """The ladder at LADDER_POINTS (the first points and scalars; a
    request's 2 × 1024 and 2 × 2048 are one row of bases twice, as
    ``msm_auto_many`` repeats them), as the checkout's wrapper picks its
    form; where the checkout has two forms, each of them at LADDER_FORMS;
    and the naive MSM of a request (the ladder and its sums) beside K2's
    ``msm_many`` at 2 × 1024 and 2 × 2048."""
    import torch

    fns = {}
    for label, n, rows in LADDER_POINTS:
        pts = (p[:n // rows].repeat(rows, 1, 1) if n <= p.shape[0]
               else p.repeat(-(-n // p.shape[0]), 1, 1)[:n]).contiguous()
        k = scalars[:n].contiguous()
        fns[f"g1_scalar_mul {label}"] = (
            lambda pts=pts, k=k: kernels.g1_scalar_mul(pts, k),
            REPS_LADDER)
        if hasattr(kernels, "_ladder") and n in LADDER_FORMS:
            for form, grouped in (("group", True), ("thread", False)):
                fns[f"g1_scalar_mul {form} form {label}"] = (
                    lambda pts=pts, k=k, g=grouped: kernels._ladder(pts, k, g),
                    REPS_LADDER)
    for n in (1024, 2048):
        sc = scalars[:2 * n].view(2, n, 8)
        fns[f"msm_auto_many 2 x {n}"] = (
            lambda sc=sc, n=n: tmsm.msm_auto_many(p[:n], sc), REPS_LADDER)
        fns[f"msm_many (K2) 2 x {n}"] = (
            lambda sc=sc, n=n: tmsm.msm_many(p[:n], sc), REPS_LADDER)
    return fns


def _fixed_fns(kernels, tmsm, p, scalars) -> dict:
    """The aggregation's two MSMs over the first m points (16, 256, 1024
    keys) as the checkout runs them, and the keys' table at 256 and 1024
    (its bases at every 8 bits: the new layout's [16^w]P_i at even w, the
    old one's every window)."""
    import torch

    fns = {}
    most = getattr(kernels, "FIXED_MAX_KEYS", None)
    for m in FIXED_KEYS:
        keys = p[:m].contiguous()
        sc = scalars[:, :m].contiguous()
        if not hasattr(kernels, "g1_msm_fixed"):
            fn = (lambda k=keys, s=sc: torch.stack(
                [tmsm.msm_naive(k, c) for c in s]))
        elif most is None or m <= most:
            table = kernels.g1_fixed_table(keys)
            fn = (lambda t=table, s=sc: kernels.g1_msm_fixed(t, s))
        else:
            continue
        fns[f"aggregation 2 MSMs {m} keys"] = (fn, REPS_FIXED)
        if m > 16 and hasattr(kernels, "g1_fixed_table"):
            fns[f"g1_fixed_table {m} keys"] = (
                lambda k=keys: _bases(kernels.g1_fixed_table(k)),
                REPS_TABLE)
    return fns


def _bases(table):
    """[2^(8v)]P_i, v < 32, from a fixed-base table of either layout."""
    return table[:, ::2, 0] if table.dim() == 5 else table


def _key_dlog(i: int) -> int:
    """The discrete log of point i of the inputs: twice the comb table's
    entry (window i // 256, digit i % 256), [d·2^(8w)]G."""
    from zkp_subnet_tpu_torch.utils import oracle as o

    return 2 * (i % 256) * pow(2, 8 * (i // 256), o.R) % o.R


def _oracle_check(outs: dict, scalars, p) -> None:
    """The aggregation's MSMs against the oracle's Σ k_i·P_i: no number is
    printed for a checkout that fails it."""
    from zkp_subnet_tpu_torch.ops import curve as cv
    from zkp_subnet_tpu_torch.ops.field import FR
    from zkp_subnet_tpu_torch.utils import oracle as o

    g = o.G1.from_affine(o.G1_GEN)
    for m in FIXED_KEYS:
        got = outs.get(f"aggregation 2 MSMs {m} keys")
        if got is None:
            continue
        got = got.view(-1, 3, 12)
        for c in range(got.shape[0]):
            ks = FR.limbs_to_ints(scalars[c, :m])
            want = sum(k * _key_dlog(i) for i, k in enumerate(ks)) % o.R
            if cv.g1_affine(got[c]) != [o.G1.to_affine(o.G1.mul(g, want))]:
                raise RuntimeError(f"aggregation MSM {c} at {m} keys != "
                                   "the oracle")


def _flat(out):
    """A kernel's output, or a tuple of them, as one tensor to compare."""
    import torch

    if isinstance(out, tuple):
        return torch.cat([t.reshape(-1) for t in out])
    return out


def _opening_fns(kernels, data, dev) -> dict:
    """The opening's kernels at one row of 2^16 and at the [mesh] batch of
    BATCH rows at one point, as the checkout runs them: with
    ``fr_power_tables`` (the tables built untimed but where they are the
    kernel timed), one launch each for all rows; before it, one launch of
    ``fr_powers`` and of ``fr_open_quotient`` a row, each building its own
    table of x^(2^j), the rows' outputs stacked as the caller stacked them.
    The first pass of the scan (untimed) is the same kernel in both."""
    import torch

    row, x, batch = _opening_batch(kernels, data, dev)
    n = row.shape[0]
    xi = kernels.fr_inv(x)
    local1, totals1 = kernels.fr_suffix_scan(row)
    local, totals = kernels.fr_suffix_scan(batch.view(-1, 8))
    local = local.view(BATCH, n, 8)
    totals = totals.view(BATCH, -1, 8)
    if not hasattr(kernels, "fr_power_tables"):
        return {
            "fr_powers 1 row": (lambda: kernels.fr_powers(x, n, row),
                                REPS_POINT),
            f"fr_powers {BATCH} rows": (lambda: torch.stack(
                [kernels.fr_powers(x, n, r) for r in batch]), REPS_BATCH),
            "fr_open_quotient 1 row": (lambda: kernels.fr_open_quotient(
                local1, totals1, x, xi, row), REPS_POINT),
            f"fr_open_quotient {BATCH} rows": (lambda: tuple(
                torch.stack(o) for o in zip(*[kernels.fr_open_quotient(
                    local[b], totals[b], x, xi, batch[b])
                    for b in range(BATCH)])), REPS_BATCH)}
    tables = kernels.fr_power_tables(x, n, xi)
    return {
        "fr_power_tables": (lambda: kernels.fr_power_tables(x, n, xi),
                            REPS_POINT),
        "fr_powers 1 row": (lambda: kernels.fr_powers(tables[0], n, row),
                            REPS_POINT),
        f"fr_powers {BATCH} rows": (
            lambda: kernels.fr_powers(tables[0], n, batch), REPS_BATCH),
        "fr_open_quotient 1 row": (lambda: kernels.fr_open_quotient(
            local1, totals1, x, tables[1], row), REPS_POINT),
        f"fr_open_quotient {BATCH} rows": (lambda: kernels.fr_open_quotient(
            local, totals, x, tables[1], batch), REPS_BATCH)}


def _opening_batch(kernels, data, dev):
    """The opening's row of 2^16, its point x (random), and the batch of
    BATCH rows: the row times each row's factor."""
    row, x = data["row"].to(dev), data["fr"][3].contiguous().to(dev)
    n = row.shape[0]
    batch = kernels.fr_mul(row.repeat(BATCH, 1), data["factors"].to(
        dev).repeat_interleave(n, 0)).view(BATCH, n, 8)
    return row, x, batch


def _scan_eval_fns(kernels, data, dev) -> dict:
    """{name: (call, reps, view)}: ``fr_suffix_scan`` at one row of 2^16
    and at the batch laid end to end, its view the opening's (y, q) from
    ``fr_open_quotient`` after the local sums and totals were held to the
    checkout's own plain version (rows BATCH_SAMPLED of the batch); and
    ``fr_eval_rows`` at 16 and at BATCH rows of the batch at x, and at the
    row at 16 points (0, 1, r − 1 and random); and the whole opening
    (``poly._open_on_card`` with 1/x given: four launches) of the row and
    of the batch. The scan, the quotient and the opening also at a default
    row of DEFAULT_ROW coefficients."""
    import torch
    from zkp_subnet_tpu_torch.ops import poly as tpoly

    row, x, batch = _opening_batch(kernels, data, dev)
    xi = kernels.fr_inv(x)
    row1k = row[:DEFAULT_ROW]
    sampled = list(BATCH_SAMPLED)

    def opened(coeffs):
        rows, n = coeffs.shape[:2]
        tables = kernels.fr_power_tables(x, n, xi)

        def view(out):
            local, totals = out
            local, totals = local.view(rows, n, 8), totals.view(rows, -1, 8)
            some = sampled if rows > 1 else [0]
            plain = tpoly.fr_suffix_scan_plain(coeffs[some])
            if not (torch.equal(local[some], plain[0])
                    and torch.equal(totals[some], plain[1])):
                raise RuntimeError("fr_suffix_scan != its plain version")
            return kernels.fr_open_quotient(local, totals, x, tables[1],
                                            coeffs)
        return view
    pts = data["fr"].to(dev)
    local1k, totals1k = kernels.fr_suffix_scan(row1k)
    tables1k = kernels.fr_power_tables(x, DEFAULT_ROW, xi)
    return {
        f"fr_suffix_scan 1 x {DEFAULT_ROW}": (
            lambda: kernels.fr_suffix_scan(row1k), REPS_POINT,
            opened(row1k[None])),
        f"fr_open_quotient 1 x {DEFAULT_ROW}": (
            lambda: kernels.fr_open_quotient(local1k, totals1k, x,
                                             tables1k[1], row1k),
            REPS_POINT),
        f"fr_opening 1 x {DEFAULT_ROW}, 1/x given": (
            lambda: tpoly._open_on_card(row1k, x, xi), REPS_POINT),
        "fr_opening 1 row, 1/x given": (
            lambda: tpoly._open_on_card(row, x, xi), REPS_POINT),
        f"fr_opening {BATCH} rows, 1/x given": (
            lambda: tpoly._open_on_card(batch, x, xi), REPS_SCAN),
        "fr_suffix_scan 1 row": (lambda: kernels.fr_suffix_scan(row),
                                 REPS_POINT, opened(row[None])),
        f"fr_suffix_scan {BATCH} rows": (
            lambda: kernels.fr_suffix_scan(batch.view(-1, 8)), REPS_SCAN,
            opened(batch)),
        "fr_eval_rows 16 rows at one point": (
            lambda: kernels.fr_eval_rows(batch[:16], x.view(1, 8)),
            REPS_EVAL),
        f"fr_eval_rows {BATCH} rows at one point": (
            lambda: kernels.fr_eval_rows(batch, x.view(1, 8)), REPS_SCAN),
        "fr_eval_rows 1 row at 16 points": (
            lambda: kernels.fr_eval_rows(row[None], pts), REPS_EVAL)}


def _inputs(path: str) -> None:
    """The inputs, from SEED, by this checkout's package."""
    import numpy as np
    import torch
    from .ops import curve as cv
    from .ops import kernels
    from .ops.field import FR

    dev = torch.device("cuda", 0)
    n = 1 << LOG_N
    base = kernels.g1_double(cv.g1_fixed_base_tables(device=dev).reshape(
        -1, 3, 12).contiguous())
    p = base.repeat(-(-n // base.shape[0]), 1, 1)[:n].contiguous()
    rng = np.random.default_rng(SEED)
    limbs = rng.integers(0, 1 << 16, (2, n, 16), dtype=np.uint32)
    limbs[..., 15] = rng.integers(0, 0x73ED, (2, n), dtype=np.uint32)
    ones = np.zeros((2, n, 16), np.uint32)
    ones[..., 0] = 1
    # Fr elements (Montgomery): 0, 1, r - 1, then random below r
    fr = rng.integers(0, 1 << 16, (16, 16), dtype=np.uint32)
    fr[:, 15] = rng.integers(0, 0x73ED, 16, dtype=np.uint32)
    fr[0], fr[1] = 0, FR.to_limbs16(FR.encode([1]))[0]
    fr[2] = FR.to_limbs16(FR.encode([FR.p - 1]))[0]
    # the opening's row of 2^16 and a factor for each row of its batch
    row = rng.integers(0, 1 << 16, (n + BATCH, 16), dtype=np.uint32)
    row[:, 15] = rng.integers(0, 0x73ED, n + BATCH, dtype=np.uint32)
    row = FR.from_limbs16(row)
    # the ladder's scalars (below r, as the MSMs' are): 2^19
    lad = rng.integers(0, 1 << 16, (1 << 19, 16), dtype=np.uint32)
    lad[:, 15] = rng.integers(0, 0x73ED, 1 << 19, dtype=np.uint32)
    torch.save({"p": p.cpu(), "q": p.roll(1, 0).cpu(),
                "ladder": FR.from_limbs16(lad, dev).cpu(),
                "fr": FR.from_limbs16(fr), "row": row[:n].clone(),
                "factors": row[n:].clone(), "scalars": {
        "uniform": FR.from_limbs16(limbs, dev).cpu(),
        "all-ones": FR.from_limbs16(ones, dev).cpu()}}, path)


def _spawn(root: str, *args: str) -> subprocess.Popen:
    """This file as ``__main__`` in a process whose imports start at the
    checkout ``root`` (so that it imports that checkout's package)."""
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=root)
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.abspath(__file__), *args], cwd=root,
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _result(proc: subprocess.Popen, what: str) -> dict:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def sass_mix(lib: str, kernel: str) -> dict:
    """Instructions of one kernel in a built library, by opcode."""
    from .ops import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function : " in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkouts", nargs="+", metavar="DIR",
                        help="roots of the checkouts, the first the "
                        "reference for the outputs")
    parser.add_argument("--only", nargs="+", default=[], metavar="PREFIX",
                        help="time only the functions whose names start "
                        "with one of these")
    args = parser.parse_args(argv)
    import torch
    from .ops import kernels

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(d) for d in args.checkouts]
    work = os.path.join(kernels.BUILD_DIR, "ab")
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, "inputs.pt")
    reference = os.path.join(work, "reference.pt")
    if os.path.exists(reference):
        os.remove(reference)
    _inputs(inputs)

    unique = list(dict.fromkeys(roots))
    builds = {root: _spawn(root, "--build") for root in unique}
    built = {root: _result(proc, f"build of {root}")
             for root, proc in builds.items()}
    runs = {root: [] for root in unique}
    for turn, root in enumerate(roots + roots[::-1]):
        res = _result(_spawn(root, "--time", inputs, reference, *args.only),
                      f"turn {turn} of {root}")
        if not res["package"].startswith(root + os.sep):
            raise RuntimeError(f"{root}: imported {res['package']}")
        runs[root].append(res)
        print(f"[turn {turn}] {root}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in res["ms"].items()), flush=True)
        if not all(res["equal"].values()):
            print(f"kernel_ab: {root} differs from {roots[0]}: "
                  f"{res['equal']}", file=sys.stderr)
            return 1
    report = []
    for root in unique:
        usage = kernels.ptxas_usage(built[root]["log"])
        mixes = {k: sass_mix(built[root]["lib"], k) for k in SASS_KERNELS}
        row = {"checkout": root,
               "ms": {k: statistics.fmean(r["ms"][k] for r in runs[root])
                      for k in runs[root][0]["ms"]},
               "runs_ms": [r["ms"] for r in runs[root]],
               "kernels": {k: usage.get(k) for k in KERNELS},
               "sass": mixes}
        report.append(row)
        print(f"[checkout] {root}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row["ms"].items()) + "; " + "; ".join(
            f"{k} {u['registers']} registers, {u['spill_stores']} B spill "
            f"stores" for k, u in row["kernels"].items() if u) + "".join(
            f"; {k} {sum(mix.values())} SASS instructions ("
            + ", ".join(f"{op} {c}" for op, c in list(mix.items())[:8])
            + ")" for k, mix in mixes.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "checkouts": report}))
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--build"]:
    print(json.dumps(child_build()))
elif __name__ == "__main__" and sys.argv[1:2] == ["--time"]:
    print(json.dumps(child_time(*sys.argv[2:])))
elif __name__ == "__main__":
    sys.exit(main())
