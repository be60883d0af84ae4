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

// The tables of x^(2^j) of fr_eval_rows (fr::square_table) live in shared
// memory.
constexpr int MAX_POW_BITS = 32;

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
// SCAN_TILE elements, SCAN_PER_THREAD consecutive ones a thread. Modular
// addition is associative and a sum has one representation, so the sums
// are the Hillis-Steele scan's limb for limb.
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_PER_THREAD = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER_THREAD;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;

__device__ __forceinline__ void shfl_down(uint32_t* r, const uint32_t* v,
                                          int d) {
#pragma unroll
  for (int j = 0; j < fr::L; j++) r[j] = __shfl_down_sync(FULL_MASK, v[j], d);
}

__device__ __forceinline__ void set_zero(uint32_t* r) {
#pragma unroll
  for (int j = 0; j < fr::L; j++) r[j] = 0;
}

// Pass 1: each block's tile, from the right. A thread sums its elements
// serially, a warp scans its lanes' sums by shuffles (8 limbs a step), the
// warps' totals meet in shared memory. Writes the tile's local inclusive
// suffix sums and the tile's total.
__global__ void __launch_bounds__(SCAN_THREADS)
fr_suffix_scan_kernel(const uint32_t* __restrict__ terms,
                      uint32_t* __restrict__ local,
                      uint32_t* __restrict__ totals, long long n) {
  __shared__ __align__(16) uint32_t warp_total[SCAN_WARPS * fr::L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first =
      blockIdx.x * (long long)SCAN_TILE + threadIdx.x * SCAN_PER_THREAD;
  uint32_t s[SCAN_PER_THREAD][fr::L], acc[fr::L];
  set_zero(acc);
#pragma unroll
  for (int e = SCAN_PER_THREAD - 1; e >= 0; e--) {
    if (first + e < n) {
      uint32_t t[fr::L];
      mont::load<fr::L>(t, terms + (first + e) * fr::L);
      fr::add(acc, acc, t);
    }
    fr::copy(s[e], acc);
  }
  // inclusive suffix over the warp's lanes of the threads' sums
  uint32_t inc[fr::L], o[fr::L], carry[fr::L];
  fr::copy(inc, acc);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    shfl_down(o, inc, d);
    if (lane + d < 32) fr::add(inc, inc, o);
  }
  // the carry into a thread: the lanes above it in its warp, then the
  // warps above its warp
  shfl_down(carry, inc, 1);
  if (lane == 31) set_zero(carry);
  if (lane == 0) mont::store<fr::L>(warp_total + warp * fr::L, inc);
  __syncthreads();
  for (int w = warp + 1; w < SCAN_WARPS; w++) {
    uint32_t t[fr::L];
    mont::load<fr::L>(t, warp_total + w * fr::L);
    fr::add(carry, carry, t);
  }
#pragma unroll
  for (int e = 0; e < SCAN_PER_THREAD; e++) {
    fr::add(s[e], s[e], carry);
    if (first + e < n) mont::store<fr::L>(local + (first + e) * fr::L, s[e]);
  }
  if (threadIdx.x == 0) mont::store<fr::L>(totals + blockIdx.x * fr::L, s[0]);
}

// Pass 2, fused with the rest of the opening, over B rows at one point: a
// block of QUOT_THREADS elements of one row (a quarter of a scan tile), one
// element a thread. Warp 0 adds the totals of the row's tiles to the right
// into the tile's carry, while every thread looks up (1/x)^(j+1) in the
// table of 1/x (fr::table_pow; its level 0 is canonical, so the power is
// too). Then S_{j+1} = local_{j+1} + carry inside the tile, the carry alone
// at the tile's last element (S_n = 0, so q_{n-1} = 0, written without a
// lookup), y_b = S_{b,0} (the row's first block), and q_j = S_{j+1} *
// (1/x)^(j+1), canonical. At x = 0 the quotient is c[1:] and a 0, from
// Montgomery form, chosen here on the card. The grid (n / QUOT_THREADS, B)
// fills the card from one row of 2^16 up; nothing is a chain but the
// carry's ~7 adds. Bound: bytes, local read and q written once (B·n·64 B),
// against one add and one product an element. On an H100 (PERF.md,
// zkp_subnet_tpu_torch/kernel_ab.py over copies) two elements a thread
// took 0.739 ms at 256 rows of 2^16 against this form's 0.763, and 0.0066
// ms at one row against 0.0058; four, 0.810 and 0.0100; and loading
// local_{j+1} before the barrier, 0.801 against 0.755.
constexpr int QUOT_THREADS = 256;
constexpr int QUOT_BLOCKS_A_TILE = SCAN_TILE / QUOT_THREADS;

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
    uint32_t o[fr::L];
    set_zero(carry);
    for (int b = tile + 1 + lane; b < tiles; b += 32) {
      mont::load<fr::L>(o, totals + (row * tiles + b) * fr::L);
      fr::add(carry, carry, o);
    }
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      shfl_down(o, carry, d);
      if (lane < d) fr::add(carry, carry, o);
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
// jax.vmap of the coordinator's challenge (runtime/coordinator.py:91). Until
// this kernel the port evaluated a row by a whole opening (fr_inv, the
// powers, both scan passes): four launches a row, 0.2 ms of them the
// inverse, and a quotient of n elements that was then dropped.
//
// Bound on the H100: bytes. A row's n coefficients are read once, n * 32 B
// (33.6 MB at the challenge's 16 rows of 2^16: ~0.010 ms at 3.35 TB/s),
// against Horner's one product and one add an element (~0.009 ms). Two
// passes, with no inverse, no scan and no quotient: pass 1 gives each
// block one tile of one row; its thread 0 squares x_r into the table of
// x_r^(2^j) as fr_powers does, each thread takes EVAL_PER_THREAD
// consecutive powers by fr::pow_run (one walk of the table, then a product
// by x a step), multiplies them by its coefficients and sums them, and the
// block reduces its threads' sums by warp shuffles, then the warps' totals
// through shared memory, into one partial sum of the (row, tile). Pass 2 is
// one warp a row adding the row's partial sums. Fr sums are exact and a
// fully reduced value has one representation, so any order of the adds
// gives the same limbs. A row of one tile needs pass 1 alone, written
// straight to the output.
constexpr int EVAL_THREADS = 256;
constexpr int EVAL_PER_THREAD = 4;
constexpr int EVAL_TILE = EVAL_THREADS * EVAL_PER_THREAD;
constexpr int EVAL_WARPS = EVAL_THREADS / 32;
constexpr int MAX_EVAL_ROWS = 65535;  // gridDim.y

// Sum of the warp's 32 values into lane 0 (the other lanes' are partial).
__device__ __forceinline__ void warp_sum(uint32_t* v, int lane) {
  uint32_t o[fr::L];
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    shfl_down(o, v, d);
    if (lane < d) fr::add(v, v, o);
  }
}

// Pass 1: grid (tiles, rows). partial[row * tiles + tile] = sum over the
// tile's k < n of c_{row,k} * x_row^k.
__global__ void __launch_bounds__(EVAL_THREADS)
fr_eval_partial_kernel(const uint32_t* __restrict__ coeffs,
                       const uint32_t* __restrict__ xs,
                       uint32_t* __restrict__ partial, long long n,
                       long long c_step, int x_step, int bits) {
  __shared__ __align__(16) uint32_t T[MAX_POW_BITS * fr::L];
  __shared__ __align__(16) uint32_t warp_total[EVAL_WARPS * fr::L];
  const long long row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    uint32_t v[fr::L];
    mont::load<fr::L>(v, xs + row * x_step);
    fr::square_table(T, v, bits);
  }
  __syncthreads();
  const uint32_t* c = coeffs + row * c_step;
  const long long first =
      blockIdx.x * (long long)EVAL_TILE + threadIdx.x * EVAL_PER_THREAD;
  uint32_t acc[fr::L];
  set_zero(acc);
  if (first < n) {
    uint32_t pw[EVAL_PER_THREAD][fr::L];
    fr::pow_run<EVAL_PER_THREAD>(pw, T, (unsigned long long)first, bits,
                                 nullptr);
#pragma unroll
    for (int e = 0; e < EVAL_PER_THREAD; e++) {
      const long long k = first + e;
      if (k >= n) break;
      uint32_t t[fr::L];
      mont::load<fr::L>(t, c + k * fr::L);
      fr::mul(t, t, pw[e]);
      fr::add(acc, acc, t);
    }
  }
  // every thread reaches the shuffles and the barrier, those past n with 0
  warp_sum(acc, lane);
  if (lane == 0) mont::store<fr::L>(warp_total + warp * fr::L, acc);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < EVAL_WARPS; w++) {
      uint32_t t[fr::L];
      mont::load<fr::L>(t, warp_total + w * fr::L);
      fr::add(acc, acc, t);
    }
    mont::store<fr::L>(partial + (row * gridDim.x + blockIdx.x) * fr::L,
                       acc);
  }
}

// Pass 2: one warp a row. out[row] = sum of partial[row * tiles + b].
__global__ void __launch_bounds__(32)
fr_eval_sum_kernel(const uint32_t* __restrict__ partial,
                   uint32_t* __restrict__ out, int tiles) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x;
  uint32_t acc[fr::L], t[fr::L];
  set_zero(acc);
  for (int b = lane; b < tiles; b += 32) {
    mont::load<fr::L>(t, partial + (row * tiles + b) * fr::L);
    fr::add(acc, acc, t);
  }
  warp_sum(acc, lane);
  if (lane == 0) mont::store<fr::L>(out + row * fr::L, acc);
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

// rows <= MAX_EVAL_ROWS rows of n >= 1 coefficients. c_step: n * fr::L, or
// 0 for one row at every point; x_step: fr::L, or 0 for one point for every
// row. bits: 1 <= bits <= MAX_POW_BITS, n <= 2^bits. partial holds rows *
// ceil(n / tile) elements (unused, and may be null, at one tile). tile: the
// caller's idea of EVAL_TILE, refused unless it is this one.
extern "C" int zkp_fr_eval_rows(const void* coeffs, const void* xs,
                                void* partial, void* out, long long rows,
                                long long n, long long c_step, int x_step,
                                int bits, int tile, void* stream) {
  if (tile != EVAL_TILE || bits < 1 || bits > MAX_POW_BITS ||
      n > (1LL << bits) || n < 1 || rows < 1 || rows > MAX_EVAL_ROWS)
    return REFUSED;
  const long long tiles = (n + EVAL_TILE - 1) / EVAL_TILE;
  if (tiles > 1 && partial == nullptr) return REFUSED;
  uint32_t* first_out = (uint32_t*)(tiles == 1 ? out : partial);
  fr_eval_partial_kernel<<<dim3((unsigned)tiles, (unsigned)rows),
                           EVAL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)coeffs, (const uint32_t*)xs, first_out, n, c_step,
      x_step, bits);
  if (tiles > 1) {
    fr_eval_sum_kernel<<<(unsigned)rows, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)partial, (uint32_t*)out, (int)tiles);
  }
  return (int)cudaGetLastError();
}
