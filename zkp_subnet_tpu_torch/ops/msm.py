"""Pippenger multi-scalar multiplication Σ k_i·P_i on torch tensors.

Contract of ``zkp_subnet_tpu/ops/msm.py:msm_auto`` (:589-626): (N, 3, 12)
Montgomery projective points and (N, 8) canonical scalars in, one (3, 12)
point out; the naive path (batched double-and-add + a tree sum) at
N ≤ 2048, Pippenger above. ``msm_many``/``msm_auto_many`` take (K, N, 8)
scalars, K MSMs over the same points, and run them side by side through
every launch, as the JAX package holds a row's commit and opening MSMs in
one jitted program (``zkp_subnet_tpu/runtime/worker.py:35-42``); ``msm`` is
the K = 1 case.

The Pippenger here is 8-bit windows (32 windows × 256 buckets) in Hopper
shape, not the TPU's sort + scan + one-hot-matmul chunk stream:

1. glue: the points are split into G contiguous groups (``_groups``), each
   scalar into 32 byte digits; every (group, MSM, window) row is sorted by
   digit, and run starts and lengths come from a bincount and a cumsum;
2. K2 ``msm_buckets``: one thread per (row, bucket) sums its run
   (replaces ``_chunk_bucket_sums``, msm.py:202);
3. K2 ``msm_reduce``: Σ_d d·B_d per row (replaces
   ``_weighted_window_sums``, msm.py:303). On the card this is bound by the
   chain of dependent point adds, so a row is cut into segments of
   ``REDUCE_SEGMENT`` buckets that lanes walk side by side, followed by a
   suffix scan and tree sums across the lanes: 27 dependent point
   operations (``reduce_depth``) where the running sum has 510;
4. K1 ``g1_add``: the G group results of each window fold in log2(G)
   launches, as the JAX package folds its chunk groups (msm.py:371-377);
5. K2 ``msm_combine``: Horner over the 32 windows of each MSM (replaces the
   sweep at msm.py:384), one warp per MSM. Its 288 dependent point
   operations are inherent, so each one is made short: the lanes of the
   warp share the independent Fq products of a point operation, following
   the schedule of ``ops/msm_rounds.py``.

Each kernel has its plain version here (``msm_buckets_plain``,
``msm_reduce_plain``, ``msm_combine_plain``), taken for CPU tensors only;
the plain reduce does the kernel's adds in the kernel's order, so the two
agree limb for limb, and the combine's fully reduced field values are the
same in any schedule. All point math is the fully reduced CIOS of
``csrc/g1.cuh``; the lazy signed-digit engine of ``ops/lazy8.py`` that the
TPU MSM runs on has no counterpart. Not ported (TPU workarounds):
``MAX_PROGRAM_N`` slicing, ``_msm_wide``, ``ops/lane.py``, the
``ZKP_MSM_*`` knobs, CHUNK/GROUP/SCAN_COLS chunking and the pad to a
multiple of 256.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import kernels
from .curve import (g1_add, g1_add_plain, g1_double_plain, g1_infinity,
                    g1_scalar_mul, g1_sum, scalar_digits)
from .field import FQ

WINDOW_BITS = 8
NUM_WINDOWS = 256 // WINDOW_BITS
NUM_BUCKETS = 1 << WINDOW_BITS

#: below this point count, batched double-and-add + tree sum is used
#: (``zkp_subnet_tpu/ops/msm.py:557``)
NAIVE_THRESHOLD = 2048

#: most point groups per MSM (the JAX package's GROUP), and the fewest
#: points a group may hold; see ``_groups``
MAX_GROUPS = 8
MIN_GROUP_POINTS = 2048

#: buckets a lane of ``msm_reduce`` walks serially; a row's 256 buckets are
#: 256 / REDUCE_SEGMENT lanes. The mirror of ``csrc/msm.cu:REDUCE_SEGMENT``,
#: for the plain version.
REDUCE_SEGMENT = 8


def _groups(n: int) -> int:
    """Point groups for an n-point MSM: the largest power of two ≤
    MAX_GROUPS that leaves ≥ MIN_GROUP_POINTS points per group. At a 2^16
    row that is 8 groups, so the bucket kernel runs 8·32·255 threads of ~32
    adds for each MSM instead of 32·255 threads of ~256."""
    g = 1
    while g < MAX_GROUPS and n // (2 * g) >= MIN_GROUP_POINTS:
        g *= 2
    return g


def bucket_runs(scalars: torch.Tensor, groups: int):
    """Sorted runs of every (group, MSM, window) row.

    ``scalars`` is (N, 8) or (K, N, 8). Returns ``perm`` (rows, n_g) int32
    point indices in digit order (K MSMs address the same N points), and
    ``starts``/``counts`` (rows, 256) int32, rows = groups·K·32 with the
    group outermost, so that the halves of the rows are the halves of the
    groups. Points past N (the padding of the last group) carry digit 0 and
    never reach a bucket that is summed."""
    if scalars.dim() == 2:
        scalars = scalars[None]
    k, n = scalars.shape[:2]
    n_g = -(-n // groups)
    digits = scalar_digits(scalars, WINDOW_BITS)           # (K, N, 32)
    if groups * n_g != n:
        digits = torch.cat([digits, digits.new_zeros(
            (k, groups * n_g - n, NUM_WINDOWS))], dim=1)
    rows = digits.view(k, groups, n_g, NUM_WINDOWS).permute(1, 0, 3, 2)
    rows = rows.reshape(groups * k * NUM_WINDOWS, n_g)
    sorted_d, order = torch.sort(rows, dim=1, stable=True)
    offset = torch.arange(groups, device=scalars.device).repeat_interleave(
        k * NUM_WINDOWS) * n_g
    perm = (order + offset[:, None]).clamp_(max=n - 1)
    counts = torch.zeros((rows.shape[0], NUM_BUCKETS), dtype=torch.int64,
                         device=scalars.device)
    counts.scatter_add_(1, sorted_d, torch.ones_like(sorted_d))
    starts = torch.cumsum(counts, dim=1) - counts
    return (perm.to(torch.int32).contiguous(),
            starts.to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous())


def run_rounds_plain(table: Sequence[Sequence[int]],
                     slots: Dict[int, torch.Tensor]) -> None:
    """What the combine kernel's warp does with a table assembled by
    ``ops/msm_rounds.py``, on (..., 12) tensors in ``slots`` (slot number →
    value), in place: every entry of a round reads before any writes."""
    ops = {1: FQ.mont_mul_plain, 2: FQ.add_plain, 3: FQ.sub_plain}
    for row in table:
        done = [(w >> 24, ops[w & 0xFF](slots[(w >> 8) & 0xFF],
                                        slots[(w >> 16) & 0xFF]))
                for w in row if w]
        slots.update(done)


# -- plain versions of K2 ----------------------------------------------------

def msm_buckets_plain(points, perm, starts, counts) -> torch.Tensor:
    """Plain version of K2 ``msm_buckets``: bucket sums (rows, B, 3, 12).

    Steps over run position k; at each step every (row, bucket ≠ 0) whose
    run is longer than k adds its k-th point, all pairs at once, in the
    kernel's order."""
    rows, nb = starts.shape
    acc = g1_infinity((rows * nb,), points.device)
    starts = starts.reshape(-1).long()
    counts = counts.reshape(-1).long().clone()
    counts.view(rows, nb)[:, 0] = 0                       # bucket 0: unused
    row_base = torch.arange(rows, device=points.device).repeat_interleave(
        nb) * perm.shape[1]
    flat_perm = perm.reshape(-1).long()
    k = 0
    while True:
        active = torch.nonzero(counts > k).squeeze(-1)
        if active.numel() == 0:
            break
        idx = flat_perm[row_base[active] + starts[active] + k]
        acc[active] = g1_add_plain(acc[active], points[idx])
        k += 1
    return acc.view(rows, nb, 3, 12)


def _reduce_lanes(nb: int, segment: int) -> int:
    """Lanes a row of ``nb`` buckets takes at this segment length; raises
    on a shape the reduction is not built for."""
    lanes = nb // segment if segment >= 2 else 0
    if lanes < 2 or lanes * segment != nb or lanes & (lanes - 1) \
            or segment & (segment - 1):
        raise ValueError(f"msm_reduce: {nb} buckets do not split into a "
                         f"power of two ≥ 2 of segments of {segment}")
    return lanes


def reduce_depth(nb: int = NUM_BUCKETS, segment: int = REDUCE_SEGMENT) -> int:
    """Longest chain of dependent point operations in ``msm_reduce``: the
    segment walk, the suffix scan, the tree sum, the doublings, one add."""
    log_j = _reduce_lanes(nb, segment).bit_length() - 1
    return (2 * segment - 3) + log_j + log_j + (segment.bit_length() - 1) + 1


def msm_reduce_plain(buckets: torch.Tensor,
                     segment: int = REDUCE_SEGMENT) -> torch.Tensor:
    """Plain version of K2 ``msm_reduce``: Σ_d d·B_d per row, by the
    kernel's adds in the kernel's order, all rows and lanes at once.

    Lane j walks buckets js+s−1 … js (S_j = Σ_i B_{js+i}, T_j = Σ_i
    i·B_{js+i}); then Σ_d d·B_d = Σ_j T_j + s·Σ_{j≥1} Σ_{k≥j} S_k: a suffix
    scan of the S_j, a tree sum of its entries 1…J−1 beside the tree sum of
    the T_j, log2 s doublings and one add. Bucket 0 has weight 0."""
    rows, nb = buckets.shape[:2]
    lanes = _reduce_lanes(nb, segment)
    seg = buckets.reshape(rows, lanes, segment, 3, 12)
    run = seg[:, :, segment - 1]
    t = run
    for i in range(segment - 2, 0, -1):
        run = g1_add_plain(run, seg[:, :, i])
        t = g1_add_plain(t, run)
    run = g1_add_plain(run, seg[:, :, 0])                  # S_j
    d = 1
    while d < lanes:                                       # Σ_{k≥j} S_k
        run = torch.cat([g1_add_plain(run[:, :lanes - d], run[:, d:]),
                         run[:, lanes - d:]], dim=1)
        d *= 2
    h = lanes // 2
    run = torch.cat([g1_infinity((rows, 1), buckets.device), run[:, 1:]],
                    dim=1)
    # lower half: entries 1…J−1 of the scan; upper half: the T_j
    x = g1_add_plain(torch.cat([run[:, :h], t[:, h:]], dim=1),
                     torch.cat([run[:, h:], t[:, :h]], dim=1))
    x = x.reshape(rows, 2, h, 3, 12)
    d = h // 2
    while d >= 1:
        x = g1_add_plain(x[:, :, :d], x[:, :, d:2 * d])
        d //= 2
    total = x[:, 0, 0]
    for _ in range(segment.bit_length() - 1):
        total = g1_double_plain(total)
    return g1_add_plain(total, x[:, 1, 0])


def msm_combine_plain(window_sums: torch.Tensor,
                      window_bits: int = WINDOW_BITS) -> torch.Tensor:
    """Plain version of K2 ``msm_combine``: Horner over the windows, most
    significant first, every chain at once. (K, W, 3, 12) → (K, 3, 12);
    (W, 3, 12) → (3, 12)."""
    if window_sums.dim() == 3:
        return msm_combine_plain(window_sums[None], window_bits)[0]
    acc = g1_infinity((window_sums.shape[0],), window_sums.device)
    for w in range(window_sums.shape[1] - 1, -1, -1):
        for _ in range(window_bits):
            acc = g1_double_plain(acc)
        acc = g1_add_plain(acc, window_sums[:, w])
    return acc


# -- K2 dispatch -----------------------------------------------------------------

def msm_buckets(points, perm, starts, counts):
    if points.is_cuda:
        return kernels.msm_buckets(points, perm, starts, counts)
    return msm_buckets_plain(points, perm, starts, counts)


def msm_reduce(buckets):
    if buckets.is_cuda:
        return kernels.msm_reduce(buckets)
    return msm_reduce_plain(buckets)


def msm_combine(window_sums, window_bits: int = WINDOW_BITS):
    if window_sums.is_cuda:
        return kernels.msm_combine(window_sums, window_bits)
    return msm_combine_plain(window_sums, window_bits)


# -- public entry points ------------------------------------------------------

def msm_many(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K MSMs over the same points by Pippenger with 8-bit windows, side by
    side through one launch of each K2 kernel. points: (N, 3, 12)
    Montgomery projective; scalars: (K, N, 8) canonical. Returns
    (K, 3, 12)."""
    k, n = scalars.shape[:2]
    if n == 0 or k == 0:
        return g1_infinity((k,), points.device)
    points = points.contiguous()
    groups = _groups(n)
    perm, starts, counts = bucket_runs(scalars, groups)
    buckets = msm_buckets(points, perm, starts, counts)
    sums = msm_reduce(buckets)                         # (G·K·W, 3, 12)
    while groups > 1:                                  # fold groups: K1 adds
        half = sums.shape[0] // 2
        sums = g1_add(sums[:half], sums[half:])
        groups //= 2
    return msm_combine(sums.view(k, NUM_WINDOWS, 3, 12), WINDOW_BITS)


def msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Σ k_i·P_i by Pippenger with 8-bit windows. points: (N, 3, 12)
    Montgomery projective; scalars: (N, 8) canonical. Returns (3, 12)."""
    return msm_many(points, scalars[None])[0]


def msm_naive(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Σ k_i·P_i by one batched double-and-add sweep and a tree sum."""
    return g1_sum(g1_scalar_mul(points, scalars))


def msm_auto(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Naive path at N ≤ NAIVE_THRESHOLD, Pippenger above."""
    if points.shape[0] <= NAIVE_THRESHOLD:
        return msm_naive(points, scalars)
    return msm(points, scalars)


def msm_auto_many(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """``msm_auto`` for (K, N, 8) scalars over the same points → (K, 3, 12):
    K naive sweeps at N ≤ NAIVE_THRESHOLD, one batched Pippenger above."""
    if points.shape[0] <= NAIVE_THRESHOLD:
        return torch.stack([msm_naive(points, s) for s in scalars])
    return msm_many(points, scalars)
