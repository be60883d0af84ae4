"""Pippenger multi-scalar multiplication Σ k_i·P_i on torch tensors.

Contract of ``zkp_subnet_tpu/ops/msm.py:msm_auto`` (:589-626): (N, 3, 12)
Montgomery projective points and (N, 8) canonical scalars in, one (3, 12)
point out; the naive path (batched double-and-add + a tree sum) at
N ≤ 2048, Pippenger above. ``msm_many``/``msm_auto_many`` take (K, N, 8)
scalars, K MSMs over the same points, and run them side by side through
every launch, as the JAX package holds a row's commit and opening MSMs in
one jitted program (``zkp_subnet_tpu/runtime/worker.py:35-42``); ``msm`` is
the K = 1 case. ``msm_fixed`` runs K MSMs over fixed bases (the Pianist
aggregation's Lagrange-Y keys) through their window table
(``fixed_table``), a K1 kernel whose tree of launches takes any number of
keys. ``msm_auto_many`` also
takes points of their own a row (K, N, 3, 12), as Pianist's
``commit_all``/``open_all`` give it every worker's bases;
``msm_auto_groups`` takes K MSMs over each of G point sets.

The Pippenger here is 8-bit windows (32 windows × 256 buckets) in Hopper
shape, not the TPU's sort + scan + one-hot-matmul chunk stream:

1. glue: the points are split into G contiguous groups (``_groups``), each
   scalar into 32 byte digits; every (group, MSM, window) row is sorted by
   digit (``bucket_runs``);
2. K2 ``msm_buckets``: the sum of every bucket of every row (replaces
   ``_chunk_bucket_sums``, msm.py:202). Like the TPU's prefix scan over the
   sorted row, the work is cut by position, not by digit: one block a row,
   each thread a fixed tile of ``bucket_tile(n)`` sorted entries walked with
   one running sum, then a segmented scan across the tiles for the runs
   that cross them. No thread adds more than the tile's length, whatever
   the digits (a row of one digit was n dependent adds in one thread);
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
the plain buckets and reduce do the kernel's adds in the kernel's order, so
the two agree limb for limb, and the combine's fully reduced field values
are the same in any schedule. All point math is the fully reduced CIOS of
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
                    g1_scalar_mul, g1_sum, scalar_digits, signed_digits,
                    tree_sum)
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

#: threads of an ``msm_buckets`` block, which sums one row; the mirror of
#: ``csrc/msm.cu:BUCKET_THREADS``, for the plain version
BUCKET_THREADS = 256

#: buckets a lane of ``msm_reduce`` walks serially; a row's 256 buckets are
#: 256 / REDUCE_SEGMENT lanes. The mirror of ``csrc/msm.cu:REDUCE_SEGMENT``,
#: for the plain version.
REDUCE_SEGMENT = 8


def _groups(n: int) -> int:
    """Point groups for an n-point MSM: the largest power of two ≤
    MAX_GROUPS that leaves ≥ MIN_GROUP_POINTS points per group. At a 2^16
    row that is 8 groups, so the bucket kernel runs 8·32 rows of 8192
    entries for each MSM, tiles of 32 entries a thread."""
    g = 1
    while g < MAX_GROUPS and n // (2 * g) >= MIN_GROUP_POINTS:
        g *= 2
    return g


def bucket_runs(scalars: torch.Tensor, groups: int):
    """Every (group, MSM, window) row in digit order.

    ``scalars`` is (N, 8) or (K, N, 8). Returns ``perm`` (rows, n_g) int32
    point indices (K MSMs address the same N points) and ``digits`` (rows,
    n_g) uint8, both in ascending digit order within a row, rows =
    groups·K·32 with the group outermost, so that the halves of the rows
    are the halves of the groups. Points past N (the padding of the last
    group) carry digit 0 and are never added."""
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
    return (perm.to(torch.int32).contiguous(),
            sorted_d.to(torch.uint8).contiguous())


def bucket_tile(n: int) -> int:
    """Sorted entries each thread of ``msm_buckets`` walks, at rows of n."""
    return -(-n // BUCKET_THREADS)


def bucket_depth(n: int, tile: int | None = None) -> int:
    """Longest chain of dependent point adds in ``msm_buckets`` at rows of
    n entries, whatever the digits: a tile's walk, the scan across the
    tiles, the head piece's add."""
    tile = tile or bucket_tile(n)
    threads = -(-n // tile)
    return (tile - 1) + (threads - 1).bit_length() + 1


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

def msm_buckets_plain(points, perm, digits, tile: int | None = None):
    """Plain version of K2 ``msm_buckets``: bucket sums (rows, 256, 3, 12),
    by the kernel's adds in the kernel's order, every (row, thread) at once.

    Thread t of a row walks the sorted entries [t·tile, (t+1)·tile) (tile =
    ``bucket_tile(n)`` unless given: the CPU tests run toy rows in tiles of
    2–8). A run of digit ≠ 0 inside the tile is summed in order from its
    first point and stored. The tile's first run may have begun in the tile
    before (head piece H: stored, finished last); its last run may go on
    into the next (piece V): V covers the whole tile and continues a run, or
    starts one. A segmented Hillis–Steele scan makes each V the sum of its
    run up to its tile (V_t = V_{t−d} + V_t while t's run reaches back past
    t − d), and a thread with H stores V_{t−1} + H."""
    rows, n = perm.shape
    dev = points.device
    out = g1_infinity((rows, NUM_BUCKETS), dev)
    if rows == 0 or n == 0:
        return out
    tile = tile or bucket_tile(n)
    threads = -(-n // tile)
    pad = (rows, threads * tile - n)
    dig = torch.cat([digits.long(), digits.new_zeros(pad).long()], 1)
    idx = torch.cat([perm.long(), perm.new_zeros(pad).long()], 1)
    t = torch.arange(threads, device=dev)
    start, end = t * tile, torch.clamp(t * tile + tile, max=n)
    first, last = dig[:, start], dig[:, end - 1]
    open_left = (first != 0) & (start > 0) & (
        dig[:, (start - 1).clamp(min=0)] == first)
    open_right = (last != 0) & (end < n) & (
        dig[:, end.clamp(max=n - 1)] == last)
    single = first == last
    r = torch.arange(rows, device=dev)[:, None].expand(rows, threads)

    acc = g1_infinity((rows, threads), dev)
    cur = torch.full((rows, threads), -1, dtype=torch.long, device=dev)
    for k in range(tile):
        live = (start + k < n)[None]
        d, src = dig[:, start + k], idx[:, start + k]
        change = live & (d != cur)
        done = change & (cur > 0)
        out[r[done], cur[done]] = acc[done]
        begin = change & (d != 0)
        acc[begin] = points[src[begin]]
        step = live & (d == cur) & (d != 0)
        acc[step] = g1_add_plain(acc[step], points[src[step]])
        cur = torch.where(change, d, cur)
    has_v = (cur > 0) & open_right
    done = (cur > 0) & ~open_right
    out[r[done], cur[done]] = acc[done]
    has_h = open_left & ~(single & open_right)
    flag = ~(has_v & single & open_left)      # False: V continues a run

    d = 1
    while d < threads:
        need = ~flag & (t >= d)
        if not bool(need.any()):
            break
        rr, tt = need.nonzero(as_tuple=True)
        acc_next, flag_next = acc.clone(), flag.clone()
        acc_next[rr, tt] = g1_add_plain(acc[rr, tt - d], acc[rr, tt])
        flag_next[rr, tt] = flag[rr, tt - d]
        acc, flag = acc_next, flag_next
        d *= 2
    rr, tt = has_h.nonzero(as_tuple=True)
    b = first[rr, tt]
    out[rr, b] = g1_add_plain(acc[rr, tt - 1], out[rr, b])
    return out


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

def msm_buckets(points, perm, digits):
    if points.is_cuda:
        return kernels.msm_buckets(points, perm, digits)
    return msm_buckets_plain(points, perm, digits)


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
    perm, digits = bucket_runs(scalars, groups)
    buckets = msm_buckets(points, perm, digits)
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
    """``msm_auto`` for (K, N, 8) scalars → (K, 3, 12), over the same points
    (N, 3, 12) or over points of their own a row (K, N, 3, 12): at
    N ≤ NAIVE_THRESHOLD one ladder over all K·N products (one launch on
    the card) and one tree of adds over the K rows (log2 N ``g1_add``
    launches), the limbs of K ``msm_naive`` calls; above, one batched
    Pippenger over shared points, or one Pippenger a row."""
    k, n = scalars.shape[:2]
    shared = points.dim() == 3
    if n <= NAIVE_THRESHOLD:
        pts = points.repeat(k, 1, 1) if shared else points.reshape(k * n, 3, -1)
        prods = g1_scalar_mul(pts, scalars.reshape(k * n, -1))
        return tree_sum(prods.view(k, n, 3, -1), g1_add,
                        g1_infinity((), prods.device))
    if shared:
        return msm_many(points, scalars)
    return torch.stack([msm(p, s) for p, s in zip(points, scalars)])


# -- K1 g1_msm_fixed: MSMs over fixed bases through a window table ------------

#: the table's windows of FIXED_DIGIT_BITS bits and the multiples of each
#: window's base it holds, and the inputs a block of ``g1_msm_fixed``'s
#: tree sums: the mirrors of ``csrc/g1.cu``, for the plain versions
FIXED_DIGIT_BITS = kernels.FIXED_DIGIT_BITS
FIXED_WINDOWS = kernels.FIXED_WINDOWS
FIXED_MULTIPLES = kernels.FIXED_MULTIPLES
FIXED_FAN_IN = kernels.FIXED_FAN_IN


def fixed_table_plain(points: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 ``g1_fixed_table``: (M, 3, 12) → (M, 64, 8, 3,
    12), table[i, w, j] = [(j + 1)·16^w]P_i, by the kernel's operations in
    the kernel's order: doubles from P_i (all points at once), a window's
    B, 2B, 4B and 8B taken on the way, then 3B = 2B + B, 5B = 4B + B,
    6B = 4B + 2B and 7B = 8B + (−B)."""
    chain = [points]
    for _ in range(FIXED_DIGIT_BITS * FIXED_WINDOWS - 1):
        chain.append(g1_double_plain(chain[-1]))
    steps = torch.stack(chain, 1).view(points.shape[0], FIXED_WINDOWS,
                                       FIXED_DIGIT_BITS, 3, FQ.L)
    e1, e2, e4, e8 = (steps[:, :, b] for b in range(FIXED_DIGIT_BITS))
    neg = e1.clone()
    neg[..., 1, :] = FQ.sub_plain(torch.zeros_like(e1[..., 1, :]),
                                  e1[..., 1, :])
    e3, e5, e6, e7 = _add_rows(torch.stack([e2, e4, e4, e8], 2),
                               torch.stack([e1, e1, e2, neg], 2)).unbind(2)
    return torch.stack([e1, e2, e3, e4, e5, e6, e7, e8], dim=2)


def fixed_table(points: torch.Tensor) -> torch.Tensor:
    """The window table of fixed bases for ``msm_fixed``: K1
    ``g1_fixed_table`` on a CUDA tensor, its plain version on the CPU."""
    if points.is_cuda:
        return kernels.g1_fixed_table(points.contiguous())
    return fixed_table_plain(points)


def fixed_digits_plain(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 8) canonical scalars below 2^255 → (..., 64) signed digits in
    [-7, 8], least significant first, Σ d_w·16^w = k: the ladder's
    recoding (``curve.signed_digits``), whose carry out of the top window
    is 0 below 2^255."""
    return signed_digits(scalars, FIXED_DIGIT_BITS)[..., :FIXED_WINDOWS]


def fixed_terms_plain(table: torch.Tensor, scalars: torch.Tensor
                      ) -> torch.Tensor:
    """The terms of K MSMs over a fixed-base table, as the first launch of
    ``g1_msm_fixed`` reads them: (K, 64·M, 3, 12), term 64·i + w =
    d·[16^w]P_i for the signed digit d = d_w(k_i), the table entry of |d|,
    negated where d < 0, infinity where d = 0."""
    k, m = scalars.shape[:2]
    d = fixed_digits_plain(scalars)                        # (K, M, 64)
    i = torch.arange(m, device=table.device)[None, :, None]
    w = torch.arange(FIXED_WINDOWS, device=table.device)[None, None, :]
    ent = table[i, w, (d.abs() - 1).clamp(min=0)]          # (K, M, 64, 3, 12)
    ent[..., 1, :] = torch.where((d < 0)[..., None], FQ.sub_plain(
        torch.zeros_like(ent[..., 1, :]), ent[..., 1, :]), ent[..., 1, :])
    ent = torch.where((d == 0)[..., None, None],
                      g1_infinity((), table.device), ent)
    return ent.reshape(k, m * FIXED_WINDOWS, 3, FQ.L)


def fixed_sum_plain(inputs: torch.Tensor) -> torch.Tensor:
    """The tree of launches of ``g1_msm_fixed`` over (K, n, 3, 12) inputs →
    (K, 3, 12): each launch cuts every row into blocks of FIXED_FAN_IN
    consecutive inputs, the last block maybe short, and sums each by
    ``tree_sum`` (a short block padded with infinity to its power of two,
    as the kernel pads it), until one sum is left."""
    k, t = inputs.shape[0], inputs
    inf = g1_infinity((), inputs.device)
    while t.shape[1] > 1:
        full, rest = divmod(t.shape[1], FIXED_FAN_IN)
        sums = []
        if full:
            sums.append(tree_sum(t[:, :full * FIXED_FAN_IN].reshape(
                k * full, FIXED_FAN_IN, 3, FQ.L), _add_rows, inf).view(
                    k, full, 3, FQ.L))
        if rest:
            sums.append(tree_sum(t[:, full * FIXED_FAN_IN:], _add_rows,
                                 inf)[:, None])
        t = torch.cat(sums, 1)
    return t[:, 0]


def _add_rows(a: torch.Tensor, b: torch.Tensor,
              rows: int = 1024) -> torch.Tensor:
    """``g1_add_plain`` of (B, h, 3, 12) operands in pieces of about
    ``rows`` points (one batched product of every point is much slower on
    the CPU than a few cache-sized ones; the values are the same)."""
    step = max(1, rows // max(1, a.shape[1]))
    return torch.cat([g1_add_plain(a[j:j + step], b[j:j + step])
                      for j in range(0, a.shape[0], step)])


def msm_fixed_plain(table: torch.Tensor, scalars: torch.Tensor
                    ) -> torch.Tensor:
    """Plain version of K1 ``g1_msm_fixed``: (M, 64, 8, 3, 12) table, (K, M,
    8) canonical scalars → (K, 3, 12), any M ≥ 1, by the kernel's adds in
    the kernel's order: the terms (``fixed_terms_plain``) summed by its
    tree of launches (``fixed_sum_plain``)."""
    return fixed_sum_plain(fixed_terms_plain(table, scalars))


def msm_fixed(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K MSMs over the M fixed bases of ``table`` (``fixed_table``'s), one
    call: scalars (K, M, 8) canonical → (K, 3, 12), any M. K1
    ``g1_msm_fixed`` on a CUDA tensor (one tree of launches whatever K), its
    plain version on the CPU. The Pianist aggregation's Lagrange-Y MSMs (C_y
    and W_y of every challenge) go through it."""
    if table.is_cuda or scalars.is_cuda:
        return kernels.g1_msm_fixed(table.contiguous(), scalars.contiguous())
    return msm_fixed_plain(table, scalars)


def msm_auto_groups(points: torch.Tensor,
                    scalars: torch.Tensor) -> torch.Tensor:
    """K MSMs over each of G point sets: points (G, N, 3, 12), scalars
    (G, K, N, 8) → (G, K, 3, 12), as the multi-device prove gives each
    worker's bases its commitments and openings. At N ≤ NAIVE_THRESHOLD
    one ``msm_auto_many`` over all G·K rows (one ladder launch, one tree of
    log2 N adds); above, one
    batched Pippenger a group (``msm_many``), where points of their own a
    row would cost one Pippenger a row."""
    g, k, n = scalars.shape[:3]
    if n <= NAIVE_THRESHOLD:
        rows = points[:, None].expand(g, k, n, 3, FQ.L).reshape(
            g * k, n, 3, FQ.L)
        return msm_auto_many(rows, scalars.reshape(g * k, n, -1)).view(
            g, k, 3, FQ.L)
    return torch.stack([msm_many(p, s) for p, s in zip(points, scalars)])
