// K3: Fr over (N, 8) elements. Elementwise Montgomery multiply, add and
// subtract, with one operand optionally broadcast (a single element, step
// 0); the pipeline of KZG openings of B rows at one point as whole kernels:
// the inverse, the tables of powers of the point and of its inverse, the
// powers times the coefficients, and a suffix scan in two passes whose
// second pass also scales the quotient; and the evaluation of many rows at
// their points, fr_eval_rows, in two passes (further down, with its own
// note).
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lane8.BFR as reached
// from poly._fmul/_fadd (zkp_subnet_tpu/ops/poly.py:37-47), ntt._f8
// (zkp_subnet_tpu/ops/ntt.py:136-143) and field.pow_static/powers
// (zkp_subnet_tpu/ops/field.py:324-359): the powers of x and 1/x, the
// termwise products, the Hillis-Steele suffix sums, the quotient scaling
// and the de-Montgomery multiply by 1 of one KZG opening; the 1/n scaling
// of the inverse NTT; the differences, inverses and barycentric sum of the
// Pianist aggregation. On the TPU each of those chains is one jitted
// program; run eagerly, the elementwise kernels cost an opening ~500
// launches (418 for the inverse alone), each of a few microseconds on the
// card and ~70 on the host.
//
// Bound on the H100. The elementwise kernels: a multiply reads 64 bytes and
// writes 32 for 128 wide multiply-adds, so at 2^16 elements bytes bound
// them (~2 us); one element per thread, moved as two 16-byte words each
// way. The opening's kernels: fr_inv is one thread's binary extended
// Euclid (latency; no bytes to speak of, see below); fr_power_tables is a
// block's chain of ~9 products a level (latency), once for all the rows
// that open at the point; fr_powers (a product an element and the lookup's
// one a power) and the two scan passes (an add an element, a product in the
// second) are bound by bytes, every element independent of the others but
// for the scan's tiles, with grids over all B rows: one launch each for any
// B, and no value goes back to the host between them: x and 1/x are read
// from device memory, and the x = 0 corner of the quotient is chosen on the
// card.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

enum Op { MUL, ADD, SUB };

template <Op OP>
__global__ void __launch_bounds__(256)
fr_binary_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 long long n, int a_step, int b_step) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fr::L], y[fr::L], r[fr::L];
  mont::load<fr::L>(x, a + i * a_step);
  mont::load<fr::L>(y, b + i * b_step);
  if (OP == MUL) fr::mul(r, x, y);
  if (OP == ADD) fr::add(r, x, y);
  if (OP == SUB) fr::sub(r, x, y);
  mont::store<fr::L>(out + i * fr::L, r);
}

constexpr int THREADS = 256;

// -- the opening's pipeline ---------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;

// out_i = 1/a_i (0 for 0), Montgomery in and out: one thread an element,
// in registers. Replaces pallas_g1.py:pfield over lane8.BFR as reached from
// field.inv (zkp_subnet_tpu/ops/field.py:343: Fermat's a^(r-2) by
// pow_static, 418 products). Bound: latency, one thread's chain of
// dependent steps, whatever the element count (1 for an opening's point,
// M for the aggregation's differences). Fermat's chain here was 417
// dependent Montgomery products (0.204 ms on an H100); fr::inv is Kaliski's
// binary inverse instead, ~180 steps of 8-word carry chains and shifts and
// two products at the end (0.024 ms). It is VARIABLE TIME: its inputs are
// public (the challenge point, beta - w^i); never hand it a secret.
constexpr int INV_THREADS = 64;

__global__ void __launch_bounds__(INV_THREADS)
fr_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
              long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fr::L];
  mont::load<fr::L>(x, a + i * fr::L);
  fr::inv(x, x);
  mont::store<fr::L>(out + i * fr::L, x);
}

// -- power tables, once a point --------------------------------------------
//
// fr_power_tables: the tables of powers that fr_powers (x) and
// fr_open_quotient (1/x) read, levels of POW_WIDTH entries each
// (fr::power_table: level l holds x^(i·256^l)), two levels at 2^16 powers,
// three at the NTT's 2^21, four up to 2^32. One block a point, POW_WIDTH
// threads, each building its entry of every level; block 1, for 1/x, stores
// level 0 out of Montgomery form (the quotient's product by the integer 1,
// folded into its table). Bound: latency, a chain of levels·9 - 1
// dependent products (a level's 8-step Hillis-Steele scan and the next
// level's base), once for all the rows that open at the point.
constexpr int POW_WIDTH = fr::POW_WIDTH;
constexpr int MAX_POW_LEVELS = 4;

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

__global__ void __launch_bounds__(POW_WIDTH)
fr_power_tables_kernel(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ xi,
                       uint32_t* __restrict__ tables, int levels) {
  __shared__ __align__(16) uint32_t S[(2 * POW_WIDTH + 1) * fr::L];
  const bool inverse = blockIdx.x == 1;
  uint32_t v[fr::L];
  mont::load<fr::L>(v, inverse ? xi : x);
  fr::power_table<fr::POW_LEVEL_BITS>(
      tables + (long long)blockIdx.x * levels * POW_WIDTH * fr::L, S, v,
      levels, inverse, threadIdx.x, BlockSync());
}

// out_{b,k} = x^k * c_{b,k} (x^k alone without c), k < n, over B rows: one
// thread a power k, looked up in x's table (levels - 1 products), then
// multiplied by c_{b,k} for POW_ROWS rows b in turn, so that the lookup is
// paid once for those rows. Every element is independent of every other;
// the grid (n / POW_THREADS, B / POW_ROWS) fills the card from one row of
// 2^16 up. Bound: bytes, c read and out written once (B·n·64 B), against
// B·n + n - 1 products the function needs. The powers row could instead be
// written once and read back for each row (2 MB at 2^16, from L2): that
// moves B·n·32 more bytes through L2 to save the lookups' products, which
// POW_ROWS already shares.
constexpr int POW_THREADS = 256;
constexpr int POW_ROWS = 8;

__global__ void __launch_bounds__(POW_THREADS)
fr_powers_kernel(const uint32_t* __restrict__ table,
                 const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
                 long long rows, long long n, int levels) {
  const long long k = blockIdx.x * (long long)POW_THREADS + threadIdx.x;
  if (k >= n) return;
  uint32_t pw[fr::L];
  fr::table_pow<fr::POW_LEVEL_BITS>(pw, table, (unsigned long long)k,
                                    levels);
  if (c == nullptr) {
    mont::store<fr::L>(out + k * fr::L, pw);
    return;
  }
  const long long first = blockIdx.y * (long long)POW_ROWS;
  const long long last = min(rows, first + POW_ROWS);
#pragma unroll 1
  for (long long b = first; b < last; b++) {
    const long long at = (b * n + k) * fr::L;
    uint32_t t[fr::L];
    mont::load<fr::L>(t, c + at);
    fr::mul(t, t, pw);
    mont::store<fr::L>(out + at, t);
  }
}

// The suffix scan S_j = sum_{k >= j} t_k in two passes over tiles of
// SCAN_TILE elements. Modular addition is associative and a sum has one
// representation, so the sums are the Hillis-Steele scan's limb for limb.
//
// Pass 1 (fr_suffix_scan) is bound by bytes: terms read and local written
// once, 64 B an element, against one add. A tile is SCAN_THREADS threads
// by SCAN_PER_THREAD elements, element e of thread t at e * SCAN_THREADS +
// t: consecutive lanes take consecutive elements, so each 16-byte load and
// store of a warp is part of one contiguous span, and one 2^16 row gives
// 128 blocks for the H100's 132 SMs. On an H100 (PERF.md, kernel_ab.py
// over copies) this took 0.0040 ms at one 2^16 row and 0.36 ms at 256
// rows (1.1x its bound); 256 threads by 2 elements 0.0043 and 0.36, and
// tiles of 256 0.0041 and 0.36, with 0.0003 ms more in fr_open_quotient,
// which adds twice the tiles' totals.
constexpr int SCAN_THREADS = 512;
constexpr int SCAN_PER_THREAD = 1;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER_THREAD;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
// the tile's runs of 32 consecutive elements, one a warp and element
constexpr int SCAN_RUNS = SCAN_WARPS * SCAN_PER_THREAD;
static_assert(SCAN_RUNS <= 32, "one warp scans the runs' totals");

__device__ __forceinline__ void shfl_down(uint32_t* r, const uint32_t* v,
                                          int d) {
#pragma unroll
  for (int j = 0; j < fr::L; j++) r[j] = __shfl_down_sync(FULL_MASK, v[j], d);
}

__device__ __forceinline__ void set_zero(uint32_t* r) {
#pragma unroll
  for (int j = 0; j < fr::L; j++) r[j] = 0;
}

// Pass 1: each block's tile, from the right. Each warp scans its lanes'
// elements by shuffles (a run of 32 consecutive elements for each of the
// thread's SCAN_PER_THREAD, side by side), the runs' totals meet in shared
// memory, and each warp scans them by shuffles for its runs' carries, so
// that one barrier is all the block waits at. Writes the tile's local
// inclusive suffix sums and the tile's total.
__global__ void __launch_bounds__(SCAN_THREADS)
fr_suffix_scan_kernel(const uint32_t* __restrict__ terms,
                      uint32_t* __restrict__ local,
                      uint32_t* __restrict__ totals, long long n) {
  __shared__ __align__(16) uint32_t run[SCAN_RUNS * fr::L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = blockIdx.x * (long long)SCAN_TILE + threadIdx.x;
  uint32_t s[SCAN_PER_THREAD][fr::L], o[fr::L];
#pragma unroll
  for (int e = 0; e < SCAN_PER_THREAD; e++) {
    const long long j = first + e * SCAN_THREADS;
    if (j < n)
      mont::load<fr::L>(s[e], terms + j * fr::L);
    else
      set_zero(s[e]);
  }
  // inclusive suffix over each run's lanes; past n the terms are 0
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int e = 0; e < SCAN_PER_THREAD; e++) {
      shfl_down(o, s[e], d);
      if (lane + d < 32) fr::add(s[e], s[e], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < SCAN_PER_THREAD; e++)
      mont::store<fr::L>(run + (e * SCAN_WARPS + warp) * fr::L, s[e]);
  }
  __syncthreads();
  // the runs' carries: an inclusive suffix over the runs' totals, in
  // element order, by every warp; a run's carry is the next run's sum, and
  // the tile's total the sum at run 0
  uint32_t v[fr::L];
  if (lane < SCAN_RUNS)
    mont::load<fr::L>(v, run + lane * fr::L);
  else
    set_zero(v);
#pragma unroll
  for (int d = 1; d < SCAN_RUNS; d <<= 1) {
    shfl_down(o, v, d);
    if (lane + d < 32) fr::add(v, v, o);
  }
  if (threadIdx.x == 0) mont::store<fr::L>(totals + blockIdx.x * fr::L, v);
#pragma unroll
  for (int e = 0; e < SCAN_PER_THREAD; e++) {
    const long long j = first + e * SCAN_THREADS;
    const int next = e * SCAN_WARPS + warp + 1;
#pragma unroll
    for (int w = 0; w < fr::L; w++)
      o[w] = __shfl_sync(FULL_MASK, v[w], next < SCAN_RUNS ? next : 0);
    if (next >= SCAN_RUNS) set_zero(o);
    fr::add(s[e], s[e], o);
    if (j < n) mont::store<fr::L>(local + j * fr::L, s[e]);
  }
}

// Pass 2, fused with the rest of the opening, over B rows at one point: a
// block of QUOT_THREADS elements of one row (QUOT_BLOCKS_A_TILE blocks a
// scan tile), one element a thread. Warp 0 adds the totals of the row's
// tiles to the right into the tile's carry, while every thread looks up
// (1/x)^(j+1) in the table of 1/x (fr::table_pow; its level 0 is
// canonical, so the power is too). Then S_{j+1} = local_{j+1} + carry
// inside the tile, the carry alone at the tile's last element (S_n = 0, so
// q_{n-1} = 0, written without a lookup), y_b = S_{b,0} (the row's first
// block), and q_j = S_{j+1} * (1/x)^(j+1), canonical. At x = 0 the
// quotient is c[1:] and a 0, from Montgomery form, chosen here on the
// card. The grid (n / QUOT_THREADS, B) fills the card from one row of 2^16
// up; nothing is a chain but the carry's adds (a lane's QUOT_CARRY_RUN
// totals tiles / 64 times, then five shuffle steps where more than lane
// 0 holds totals).
// Bound: bytes, local read and q written once (B·n·64 B), against one add
// and one product an element. On an H100 (PERF.md,
// zkp_subnet_tpu_torch/kernel_ab.py over copies, with scan tiles of 1024)
// two elements a thread took 0.739 ms at 256 rows of 2^16 against this
// form's 0.763, and 0.0066 ms at one row against 0.0058; four, 0.810 and
// 0.0100; and loading local_{j+1} before the barrier, 0.801 against
// 0.755.
constexpr int QUOT_THREADS = 256;
constexpr int QUOT_BLOCKS_A_TILE = SCAN_TILE / QUOT_THREADS;
constexpr int QUOT_CARRY_RUN = 2;  // tiles' totals a lane loads at once
static_assert(SCAN_TILE % QUOT_THREADS == 0, "whole blocks a scan tile");

__global__ void __launch_bounds__(QUOT_THREADS)
fr_open_quotient_kernel(const uint32_t* __restrict__ local,
                        const uint32_t* __restrict__ totals,
                        const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ xi_table,
                        const uint32_t* __restrict__ coeffs,
                        uint32_t* __restrict__ y, uint32_t* __restrict__ q,
                        long long n, int tiles, int levels) {
  __shared__ __align__(16) uint32_t carry_s[fr::L];
  const long long row = blockIdx.y;
  const int tile = blockIdx.x / QUOT_BLOCKS_A_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j = blockIdx.x * (long long)QUOT_THREADS + threadIdx.x;
  const long long at = row * n + j;
  uint32_t v[fr::L], carry[fr::L], pw[fr::L];
  mont::load<fr::L>(v, x);
  const bool at_zero = fr::is_zero(v);
  if (warp == 0) {
    // lane l takes QUOT_CARRY_RUN totals at once from b = tile + 1 + l *
    // QUOT_CARRY_RUN, their loads out together, so that a 2^16 row's 128
    // tiles cost a lane two round trips, as its 64 tiles of 1024 did one at
    // a time
    set_zero(carry);
    for (int b = tile + 1 + QUOT_CARRY_RUN * lane; b < tiles;
         b += 32 * QUOT_CARRY_RUN) {
      uint32_t o[QUOT_CARRY_RUN][fr::L];
#pragma unroll
      for (int i = 0; i < QUOT_CARRY_RUN; i++) {
        if (b + i < tiles)
          mont::load<fr::L>(o[i], totals + (row * tiles + b + i) * fr::L);
        else
          set_zero(o[i]);
      }
#pragma unroll
      for (int i = 0; i < QUOT_CARRY_RUN; i++) fr::add(carry, carry, o[i]);
    }
    // the lanes' sum, unless lane 0 holds them all (as the first tile of a
    // row of two tiles does)
    if (tiles - tile > QUOT_CARRY_RUN + 1) {
      uint32_t o[fr::L];
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) {
        shfl_down(o, carry, d);
        if (lane < d) fr::add(carry, carry, o);
      }
    }
    if (lane == 0) mont::store<fr::L>(carry_s, carry);
  }
  if (!at_zero && j + 1 < n)
    fr::table_pow<fr::POW_LEVEL_BITS>(pw, xi_table,
                                      (unsigned long long)(j + 1), levels);
  __syncthreads();
  mont::load<fr::L>(carry, carry_s);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    mont::load<fr::L>(v, local + row * n * fr::L);
    fr::add(v, v, carry);
    mont::store<fr::L>(y + row * fr::L, v);
  }
  if (j >= n) return;
  set_zero(v);
  if (at_zero) {
    if (j + 1 < n) {
      uint32_t one[fr::L] = {1};  // the integer 1: a product by it is
                                  // from_mont
      mont::load<fr::L>(v, coeffs + (at + 1) * fr::L);
      fr::mul(v, v, one);
    }
  } else if (j + 1 < n) {
    const long long tile_end = min(n, (tile + 1) * (long long)SCAN_TILE);
    if (j + 1 < tile_end) {
      mont::load<fr::L>(v, local + (at + 1) * fr::L);
      fr::add(v, v, carry);
    } else {
      fr::copy(v, carry);
    }
    fr::mul(v, v, pw);
  }
  mont::store<fr::L>(q + at * fr::L, v);
}

// -- the challenge's row evaluation ----------------------------------------
//
// fr_eval_rows: y_r = sum_k c_{r,k} * x_r^k for R rows of n coefficients,
// each row at its own point, or every row at one point (x_step 0), or one
// row at R points (c_step 0). Replaces pallas_g1.py:pfield over lane8.BFR
// as poly._fmul and poly._tree_sum_lane reach it from poly_eval
// (zkp_subnet_tpu/ops/poly.py:85-95): the termwise products of a row and a
// table of powers, then a halving tree of adds, once a row under the
// jax.vmap of the coordinator's challenge (runtime/coordinator.py:91).
//
// Bound on the H100: bytes. A row's n coefficients are read once, n * 32 B
// (33.6 MB at the challenge's 16 rows of 2^16: ~0.010 ms at 3.35 TB/s),
// against Horner's one product and one add an element (~0.009 ms at the
// integer rate). So the design spends about one product an element and
// keeps every chain short. Pass 1 gives each block one tile of EVAL_TILE
// elements of one row, or of up to EVAL_ROWS rows that share their point
// where there are enough rows to fill the card with blocks. Warp w takes
// the tile's run of EVAL_CHUNK elements from w * EVAL_CHUNK, lane l the
// EVAL_STEPS coefficients l + 32e of that run (each load of a warp one
// contiguous span), by Horner's steps from the top with X = x^32
// (fr::horner_step: one product and one add a coefficient, the value kept
// below 2r until the next product reduces it). Lane l's value times x^l,
// summed over the lanes by shuffles (adds only), is the run's; the tile's
// is the warps' values joined by a tree of Horner steps (fr::tree_step
// with Z^4, Z^2, Z, Z = x^EVAL_CHUNK) in one warp. x^l and x^32 come from
// warp 0's product scan by shuffles (warp_powers: five steps) before the
// others start; Z's powers are squarings of x^32 that warp 0 takes during
// its first run. Pass 2 is one warp a row: lane l takes the tiles l + 32i
// by Horner's steps with x^(32 EVAL_TILE), times x^(EVAL_TILE l), then the
// lanes' sum. Those powers come from one more block of pass 1 a point, in
// front of the tiles (x^EVAL_TILE by squarings, then the same scan), off
// the tiles' path. A row of one tile needs pass 1 alone, written straight
// to the output. Fr sums are exact and a fully reduced value has one
// representation, so any order of the adds gives the same limbs.
//
// On an H100 (PERF.md, kernel_ab.py over copies) this takes 0.037 ms at
// 16 rows of 2^16 and 0.40 ms at 256; the design before, where one thread
// of every block squared x into a table of x^(2^j) while the others waited
// and an element cost ~3.75 products, 0.126 and 1.80. What is left is the
// products' own instructions: ~6.3 SM cycles an element at 256 rows, 2.8x
// the integer rate the bound assumes, since each 32-bit limb product is
// two multiply-adds (its lo and hi halves). 16 Horner steps a lane (tiles
// of 4096) were slower, with half the blocks; prefetching the first row
// into L2 cost registers (64 with 8 B of spills) and time.
constexpr int EVAL_THREADS = 256;
constexpr int EVAL_WARPS = EVAL_THREADS / 32;
constexpr int EVAL_LOG_STEPS = 3;
constexpr int EVAL_STEPS = 1 << EVAL_LOG_STEPS;  // Horner's steps a lane
constexpr int EVAL_CHUNK = 32 * EVAL_STEPS;       // a warp's run
constexpr int EVAL_TILE = EVAL_WARPS * EVAL_CHUNK;
constexpr int EVAL_LOG_TILE = 5 + EVAL_LOG_STEPS + 3;
// rows a block at most where the rows share a point (the C entry takes
// fewer where more would leave an SM fewer than EVAL_BLOCKS_AN_SM blocks),
// and the blocks an SM holds at once (registers: at most 64 a thread)
constexpr int EVAL_ROWS = 4;
constexpr int EVAL_BLOCKS_AN_SM = 4;
// pass 2's powers of a point: x^(EVAL_TILE l) for l < 32, x^(32 EVAL_TILE)
constexpr int EVAL_POWERS = 33;
constexpr int MAX_EVAL_ROWS = 65535;  // gridDim.y
static_assert(EVAL_WARPS == 8, "the tree joins 8 warps by Z^4, Z^2, Z");
static_assert(EVAL_TILE == 1 << EVAL_LOG_TILE, "a tile of 2^k elements");
static_assert(EVAL_ROWS * EVAL_WARPS <= 32, "one warp joins a block's rows");
static_assert(EVAL_LOG_STEPS + 2 <= EVAL_STEPS, "Z's squarings in one run");

// Sum of the warp's 32 values into lane 0 (the other lanes' are partial).
__device__ __forceinline__ void warp_sum(uint32_t* v, int lane) {
  uint32_t o[fr::L];
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    shfl_down(o, v, d);
    if (lane < d) fr::add(v, v, o);
  }
}

// Lane l: v = b^l and top = b^32 (every lane), by a Hillis-Steele product
// scan of (1, b, b, ...) over the warp's lanes, five steps of shuffles.
// After four, lane 16 holds b^16, whose square is taken beside the fifth
// step's product; every lane takes each product and keeps it where its
// lane needs it, so that no product waits on a branch.
__device__ __forceinline__ void warp_powers(uint32_t* v, uint32_t* top,
                                            const uint32_t* b, int lane) {
  uint32_t o[fr::L], t[fr::L];
#pragma unroll
  for (int j = 0; j < fr::L; j++) v[j] = lane == 0 ? fr::ONE[j] : b[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d == 16) {
#pragma unroll
      for (int j = 0; j < fr::L; j++)
        o[j] = __shfl_sync(FULL_MASK, v[j], 16);
      fr::mul(top, o, o);
    }
#pragma unroll
    for (int j = 0; j < fr::L; j++)
      o[j] = __shfl_up_sync(FULL_MASK, v[j], d);
    fr::mul(t, v, o);
#pragma unroll
    for (int j = 0; j < fr::L; j++) v[j] = lane >= d ? t[j] : v[j];
  }
}

// Pass 1: grid (tiles, row groups of `group` rows), and where a row has
// more than one tile one block more in front of the tiles, for pass 2's
// powers of each point. partial[row * tiles + tile] = sum over the tile's
// k < n of c_{row,k} * x_row^(k - tile * EVAL_TILE); at one tile it is the
// output.
__global__ void __launch_bounds__(EVAL_THREADS, EVAL_BLOCKS_AN_SM)
fr_eval_partial_kernel(const uint32_t* __restrict__ coeffs,
                       const uint32_t* __restrict__ xs,
                       uint32_t* __restrict__ partial,
                       uint32_t* __restrict__ powers, long long n,
                       long long c_step, int x_step, int rows, int group,
                       int tiles) {
  __shared__ __align__(16) uint32_t xl[32 * fr::L];  // x^l, l < 32
  __shared__ __align__(16) uint32_t zp[4 * fr::L];   // x^32, Z, Z^2, Z^4
  __shared__ __align__(16) uint32_t run[EVAL_ROWS * EVAL_WARPS * fr::L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first_row = blockIdx.y * group;
  const int nrows = min(group, rows - first_row);
  const uint32_t* x = xs + (long long)first_row * x_step;
  uint32_t v[fr::L], X[fr::L], h[fr::L], t[fr::L];
  if (tiles > 1 && blockIdx.x == 0) {
    // pass 2's powers: x^(EVAL_TILE l) and x^(32 EVAL_TILE), once a point
    if (warp != 0 || (x_step == 0 && blockIdx.y != 0)) return;
    mont::load<fr::L>(h, x);
#pragma unroll 1
    for (int s = 0; s < EVAL_LOG_TILE; s++) fr::mul(h, h, h);
    warp_powers(v, X, h, lane);
    uint32_t* pw = powers + (long long)(x_step == 0 ? 0 : first_row) *
                                EVAL_POWERS * fr::L;
    mont::store<fr::L>(pw + lane * fr::L, v);
    if (lane == 0) mont::store<fr::L>(pw + 32 * fr::L, X);
    return;
  }
  const long long tile = blockIdx.x - (tiles > 1);
  const long long first = tile * EVAL_TILE + warp * EVAL_CHUNK + lane;
  if (warp == 0) {
    mont::load<fr::L>(h, x);
    warp_powers(v, X, h, lane);
    mont::store<fr::L>(xl + lane * fr::L, v);
    if (lane == 0) mont::store<fr::L>(zp, X);
  }
  __syncthreads();
  mont::load<fr::L>(X, zp);
  fr::copy(v, X);  // warp 0: Z and its squares, from x^32
#pragma unroll 1
  for (int r = 0; r < nrows; r++) {
    const uint32_t* c = coeffs + (first_row + r) * c_step;
#pragma unroll
    for (int e = EVAL_STEPS - 1; e >= 0; e--) {
      const long long k = first + 32 * e;
      if (k < n)
        mont::load<fr::L>(t, c + k * fr::L);
      else
        set_zero(t);
      if (e == EVAL_STEPS - 1)
        fr::copy(h, t);
      else
        fr::horner_step(h, X, t);
      const int s = EVAL_STEPS - 1 - e;  // squaring s + 1 of x^32
      if (warp == 0 && r == 0 && s < EVAL_LOG_STEPS + 2) {
        fr::mul(v, v, v);
        if (s + 2 > EVAL_LOG_STEPS && lane == 0)
          mont::store<fr::L>(zp + (s + 2 - EVAL_LOG_STEPS) * fr::L, v);
      }
    }
    mont::load<fr::L>(t, xl + lane * fr::L);
    fr::mul(h, t, h);  // h < 2r read as the scanned operand: below r again
    warp_sum(h, lane);
    if (lane == 0)
      mont::store<fr::L>(run + (r * EVAL_WARPS + warp) * fr::L, h);
  }
  __syncthreads();
  if (warp != 0) return;
  // lane r * EVAL_WARPS + w holds warp w's run of row r: the tree over w
  const int r = lane / EVAL_WARPS, w = lane % EVAL_WARPS;
  if (r < nrows)
    mont::load<fr::L>(h, run + lane * fr::L);
  else
    set_zero(h);
#pragma unroll
  for (int d = EVAL_WARPS / 2, j = 3; d >= 1; d >>= 1, j--) {
    shfl_down(t, h, d);
    mont::load<fr::L>(v, zp + j * fr::L);  // Z^d
    if (w < d) fr::tree_step(h, h, t, v);
  }
  if (w == 0 && r < nrows)
    mont::store<fr::L>(partial + ((first_row + r) * (long long)tiles + tile) *
                                     fr::L, h);
}

// Pass 2: one warp a row. out[row] = sum over b < tiles of partial[row *
// tiles + b] * x^(b * EVAL_TILE): lane l takes the tiles l + 32i by Horner's
// steps with x^(32 EVAL_TILE), times x^(EVAL_TILE l), then the lanes' sum.
__global__ void __launch_bounds__(32)
fr_eval_sum_kernel(const uint32_t* __restrict__ partial,
                   const uint32_t* __restrict__ powers,
                   uint32_t* __restrict__ out, int tiles, int x_step) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* pw = powers + (x_step == 0 ? 0 : row) * EVAL_POWERS * fr::L;
  const int steps = (tiles + 31) / 32;
  uint32_t h[fr::L], t[fr::L], X[fr::L];
  mont::load<fr::L>(X, pw + 32 * fr::L);
#pragma unroll 1
  for (int i = steps - 1; i >= 0; i--) {
    const int b = lane + 32 * i;
    if (b < tiles)
      mont::load<fr::L>(t, partial + (row * tiles + b) * fr::L);
    else
      set_zero(t);
    if (i == steps - 1)
      fr::copy(h, t);
    else
      fr::horner_step(h, X, t);
  }
  mont::load<fr::L>(t, pw + lane * fr::L);
  fr::mul(h, t, h);  // h < 2r read as the scanned operand: below r again
  warp_sum(h, lane);
  if (lane == 0) mont::store<fr::L>(out + row * fr::L, h);
}

constexpr int REFUSED = (int)cudaErrorInvalidValue;

// a_step / b_step: fr::L for a full operand, 0 for a broadcast single one.
template <Op OP>
int launch(const void* a, const void* b, void* out, long long n, int a_step,
           int b_step, void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    fr_binary_kernel<OP><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
        b_step);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkp_fr_mul(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<MUL>(a, b, out, n, a_step, b_step, stream);
}

extern "C" int zkp_fr_add(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<ADD>(a, b, out, n, a_step, b_step, stream);
}

extern "C" int zkp_fr_sub(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<SUB>(a, b, out, n, a_step, b_step, stream);
}

extern "C" int zkp_fr_inv(const void* a, void* out, long long n,
                          void* stream) {
  if (n > 0) {
    const long long blocks = (n + INV_THREADS - 1) / INV_THREADS;
    fr_inv_kernel<<<(unsigned)blocks, INV_THREADS, 0,
                    (cudaStream_t)stream>>>((const uint32_t*)a,
                                            (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// The tables of x and, where xi is not null, of 1/x: tables holds one or two
// tables of `levels` levels of `width` elements. width: the caller's idea
// of POW_WIDTH, refused unless it is this one.
extern "C" int zkp_fr_power_tables(const void* x, const void* xi,
                                   void* tables, int levels, int width,
                                   void* stream) {
  if (width != POW_WIDTH || levels < 1 || levels > MAX_POW_LEVELS)
    return REFUSED;
  fr_power_tables_kernel<<<xi == nullptr ? 1 : 2, POW_WIDTH, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)xi, (uint32_t*)tables, levels);
  return (int)cudaGetLastError();
}

// Largest n whose powers x^k, k < n, a table of `levels` levels holds.
static long long table_reach(int levels) {
  return 1LL << (fr::POW_LEVEL_BITS * levels);
}

// table: x's table of `levels` levels of `width` elements; c may be null
// (x^k alone, one row), else rows x n elements, as out. Refused: another
// width, a table that does not reach n, more rows than the grid takes.
extern "C" int zkp_fr_powers(const void* table, const void* c, void* out,
                             long long rows, long long n, int levels,
                             int width, void* stream) {
  const long long row_blocks = (rows + POW_ROWS - 1) / POW_ROWS;
  if (width != POW_WIDTH || levels < 1 || levels > MAX_POW_LEVELS ||
      n > table_reach(levels) || rows < 1 || row_blocks > 65535 ||
      (c == nullptr && rows != 1))
    return REFUSED;
  if (n > 0) {
    const long long blocks = (n + POW_THREADS - 1) / POW_THREADS;
    fr_powers_kernel<<<dim3((unsigned)blocks, (unsigned)row_blocks),
                       POW_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const uint32_t*)c, (uint32_t*)out, rows, n,
        levels);
  }
  return (int)cudaGetLastError();
}

// tile: the caller's idea of SCAN_TILE, refused unless it is this one;
// totals holds ceil(n / tile) elements.
extern "C" int zkp_fr_suffix_scan(const void* terms, void* local,
                                  void* totals, long long n, int tile,
                                  void* stream) {
  if (tile != SCAN_TILE) return REFUSED;
  if (n > 0) {
    const long long blocks = (n + SCAN_TILE - 1) / SCAN_TILE;
    fr_suffix_scan_kernel<<<(unsigned)blocks, SCAN_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)terms, (uint32_t*)local, (uint32_t*)totals, n);
  }
  return (int)cudaGetLastError();
}

// rows x n elements of local, coeffs and q, rows x ceil(n / tile) of
// totals, rows of y; xi_table: 1/x's table of `levels` levels of `width`
// elements (level 0 canonical). (1/x)^(j+1) for j + 1 < n needs n - 1
// within the table's reach. tile and width: the caller's ideas of SCAN_TILE
// and POW_WIDTH, refused unless they are these.
extern "C" int zkp_fr_open_quotient(const void* local, const void* totals,
                                    const void* x, const void* xi_table,
                                    const void* coeffs, void* y, void* q,
                                    long long rows, long long n, int levels,
                                    int tile, int width, void* stream) {
  if (tile != SCAN_TILE || width != POW_WIDTH || levels < 1 ||
      levels > MAX_POW_LEVELS || n - 1 >= table_reach(levels) || rows < 1 ||
      rows > 65535)
    return REFUSED;
  if (n > 0) {
    const long long blocks = (n + QUOT_THREADS - 1) / QUOT_THREADS;
    const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
    fr_open_quotient_kernel<<<dim3((unsigned)blocks, (unsigned)rows),
                              QUOT_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)local, (const uint32_t*)totals, (const uint32_t*)x,
        (const uint32_t*)xi_table, (const uint32_t*)coeffs, (uint32_t*)y,
        (uint32_t*)q, n, (int)tiles, levels);
  }
  return (int)cudaGetLastError();
}

// The card's SMs, asked once a process.
static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    sms = count > 0 ? count : 1;
  }
  return sms;
}

// rows <= MAX_EVAL_ROWS rows of n >= 1 coefficients. c_step: n * fr::L, or
// 0 for one row at every point; x_step: fr::L, or 0 for one point for every
// row. scratch holds rows * ceil(n / tile) partial sums, then EVAL_POWERS
// elements a point (one point where x_step is 0, else rows); it is unused,
// and may be null, at one tile. tile: the caller's idea of EVAL_TILE,
// refused unless it is this one.
extern "C" int zkp_fr_eval_rows(const void* coeffs, const void* xs,
                                void* scratch, void* out, long long rows,
                                long long n, long long c_step, int x_step,
                                int tile, void* stream) {
  if (tile != EVAL_TILE || n < 1 || n >= (1LL << 31) || rows < 1 ||
      rows > MAX_EVAL_ROWS)
    return REFUSED;
  const long long tiles = (n + EVAL_TILE - 1) / EVAL_TILE;
  if (tiles > 1 && scratch == nullptr) return REFUSED;
  // rows a block: where they share a point, as many (up to EVAL_ROWS) as
  // leave the grid EVAL_BLOCKS_AN_SM blocks an SM; their chain of powers
  // of x is then built once for them all
  int group = 1;
  if (x_step == 0) {
    const long long fill = (long long)EVAL_BLOCKS_AN_SM * sm_count();
    while (group < EVAL_ROWS &&
           tiles * ((rows + 2 * group - 1) / (2 * group)) >= fill)
      group *= 2;
  }
  const long long groups = (rows + group - 1) / group;
  uint32_t* partial = (uint32_t*)(tiles == 1 ? out : scratch);
  uint32_t* powers =
      tiles == 1 ? nullptr : (uint32_t*)scratch + rows * tiles * fr::L;
  fr_eval_partial_kernel<<<dim3((unsigned)(tiles + (tiles > 1)),
                                (unsigned)groups),
                           EVAL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)coeffs, (const uint32_t*)xs, partial, powers, n,
      c_step, x_step, (int)rows, group, (int)tiles);
  if (tiles > 1) {
    fr_eval_sum_kernel<<<(unsigned)rows, 32, 0, (cudaStream_t)stream>>>(
        partial, powers, (uint32_t*)out, (int)tiles, x_step);
  }
  return (int)cudaGetLastError();
}
