"""Pippenger multi-scalar multiplication Σ k_i·P_i on torch tensors.

Contract of ``zkp_subnet_tpu/ops/msm.py:msm_auto`` (:589-626): (N, 3, 12)
Montgomery projective points and (N, 8) canonical scalars in, one (3, 12)
point out; the naive path (batched double-and-add + a tree sum) at
N ≤ 2048, Pippenger above.

The Pippenger here is 8-bit windows (32 windows × 256 buckets) in Hopper
shape, not the TPU's sort + scan + one-hot-matmul chunk stream:

1. glue: the points are split into G contiguous groups (``_groups``), each
   scalar into 32 byte digits; every (group, window) row is sorted by
   digit, and run starts and lengths come from a bincount and a cumsum;
2. K2 ``msm_buckets``: one thread per (row, bucket) sums its run;
3. K2 ``msm_reduce``: Σ_d d·B_d per row by the running sum;
4. K1 ``g1_add``: the G group results of each window fold in log2(G)
   launches, as the JAX package folds its chunk groups (msm.py:371-377);
5. K2 ``msm_combine``: Horner over the 32 windows.

Each kernel has its plain version here (``msm_buckets_plain``,
``msm_reduce_plain``, ``msm_combine_plain``), taken for CPU tensors only.
All point math is the fully reduced CIOS of ``csrc/g1.cuh``; the lazy
signed-digit engine of ``ops/lazy8.py`` that the TPU MSM runs on has no
counterpart. Not ported (TPU workarounds): ``MAX_PROGRAM_N`` slicing,
``_msm_wide``, ``ops/lane.py``, the ``ZKP_MSM_*`` knobs,
CHUNK/GROUP/SCAN_COLS chunking and the pad to a multiple of 256.
"""

from __future__ import annotations

import torch

from . import kernels
from .curve import (g1_add, g1_add_plain, g1_double_plain, g1_infinity,
                    g1_scalar_mul, g1_sum)

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


def _groups(n: int) -> int:
    """Point groups for an n-point MSM: the largest power of two ≤
    MAX_GROUPS that leaves ≥ MIN_GROUP_POINTS points per group. At a 2^16
    row that is 8 groups, so the bucket kernel runs 8·32·255 threads of ~32
    adds instead of 32·255 threads of ~256."""
    g = 1
    while g < MAX_GROUPS and n // (2 * g) >= MIN_GROUP_POINTS:
        g *= 2
    return g


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 canonical scalars → (N, 32) int64 byte digits, least
    significant window first."""
    s = scalars.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 8, device=scalars.device)
    return ((s.unsqueeze(-1) >> shifts) & 0xFF).flatten(-2)


def bucket_runs(scalars: torch.Tensor, groups: int):
    """Sorted runs of every (group, window) row.

    Returns ``perm`` (rows, n_g) int32 global point indices in digit order,
    and ``starts``/``counts`` (rows, 256) int32, rows = groups·32. Points
    past N (the padding of the last group) carry digit 0 and never reach a
    bucket that is summed."""
    n = scalars.shape[0]
    n_g = -(-n // groups)
    digits = _digits(scalars)
    if groups * n_g != n:
        digits = torch.cat([digits, digits.new_zeros(
            (groups * n_g - n, NUM_WINDOWS))])
    rows = digits.view(groups, n_g, NUM_WINDOWS).transpose(1, 2)
    rows = rows.reshape(groups * NUM_WINDOWS, n_g)
    sorted_d, order = torch.sort(rows, dim=1, stable=True)
    offset = torch.arange(groups, device=scalars.device).repeat_interleave(
        NUM_WINDOWS) * n_g
    perm = (order + offset[:, None]).clamp_(max=n - 1)
    counts = torch.zeros((rows.shape[0], NUM_BUCKETS), dtype=torch.int64,
                         device=scalars.device)
    counts.scatter_add_(1, sorted_d, torch.ones_like(sorted_d))
    starts = torch.cumsum(counts, dim=1) - counts
    return (perm.to(torch.int32).contiguous(),
            starts.to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous())


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


def msm_reduce_plain(buckets: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 ``msm_reduce``: Σ_d d·B_d per row by the running
    sum, all rows at once."""
    rows, nb = buckets.shape[:2]
    running = g1_infinity((rows,), buckets.device)
    total = g1_infinity((rows,), buckets.device)
    for d in range(nb - 1, 0, -1):
        running = g1_add_plain(running, buckets[:, d])
        total = g1_add_plain(total, running)
    return total


def msm_combine_plain(window_sums: torch.Tensor,
                      window_bits: int = WINDOW_BITS) -> torch.Tensor:
    """Plain version of K2 ``msm_combine``: Horner over the windows, most
    significant first."""
    acc = g1_infinity((), window_sums.device)
    for w in range(window_sums.shape[0] - 1, -1, -1):
        for _ in range(window_bits):
            acc = g1_double_plain(acc)
        acc = g1_add_plain(acc, window_sums[w])
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

def msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Σ k_i·P_i by Pippenger with 8-bit windows. points: (N, 3, 12)
    Montgomery projective; scalars: (N, 8) canonical. Returns (3, 12)."""
    n = points.shape[0]
    if n == 0:
        return g1_infinity((), points.device)
    points = points.contiguous()
    groups = _groups(n)
    perm, starts, counts = bucket_runs(scalars, groups)
    buckets = msm_buckets(points, perm, starts, counts)
    sums = msm_reduce(buckets)                         # (G·W, 3, 12)
    while groups > 1:                                  # fold groups: K1 adds
        half = groups // 2 * NUM_WINDOWS
        sums = g1_add(sums[:half].contiguous(), sums[half:].contiguous())
        groups //= 2
    return msm_combine(sums, WINDOW_BITS)


def msm_naive(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Σ k_i·P_i by one batched double-and-add sweep and a tree sum."""
    return g1_sum(g1_scalar_mul(points, scalars))


def msm_auto(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Naive path at N ≤ NAIVE_THRESHOLD, Pippenger above."""
    if points.shape[0] <= NAIVE_THRESHOLD:
        return msm_naive(points, scalars)
    return msm(points, scalars)
