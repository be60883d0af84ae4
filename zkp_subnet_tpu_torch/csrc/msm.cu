// K2: the Pippenger bucket machinery (8-bit windows) over G1 points.
//
// Replaces the XLA graph around pfield∘ZFQ in zkp_subnet_tpu/ops/msm.py:
// _chunk_bucket_sums (:202-300: sort, prefix scan, one-hot run-end
// matmuls, forward fill, bucket differences), _weighted_window_sums
// (:303-316) and the Horner sweep (:384-392).
//
// Three kernels over the complete add/double of g1.cuh, all deterministic
// (no atomics, fixed order). A row is one window of one point group of one
// MSM; K MSMs over the same bases share every launch.
//
//  (a) msm_buckets: the sum of the points in every bucket != 0 of a row
//      (the glue in ops/msm.py sorts each row's digits). Bound on this card:
//      integer multiplies (a point add is ~4,100 32-bit multiply-adds) and,
//      when one thread walks a whole run, the longest run: a row of equal
//      digits was 8192 dependent adds in one thread. So the work is cut by
//      position, not by digit, as the TPU's prefix scan over the sorted row
//      does: one block a row, each thread a fixed tile of the sorted
//      entries (T = 32 at the path's 8192 points a row), with a segmented
//      scan across the tiles for the runs that cross them. The adds are
//      expanded in place (csrc/g1.cuh), in registers, 8 warps an SM.
//
//  (b) msm_reduce: sum_d d·B_d per row. Bound on this card: the length of
//      the chain of dependent point adds, not bytes or multiplies (a row
//      is 36 KB and ~800 adds). So the chain is cut: J = B/S lanes share a
//      row (S = REDUCE_SEGMENT = 8, chosen by measurement over 4 and 2),
//      lane j walks the S buckets of segment j top-down with the
//      running sum (S_j = sum_i B_{jS+i}, T_j = sum_i i·B_{jS+i}), and
//      sum_d d·B_d = sum_j T_j + S·sum_{j>=1} sum_{k>=j} S_k: a suffix scan
//      of the S_j across the lanes, a tree sum of its entries 1..J-1 (the
//      tree sum of the T_j rides in the idle half of the lanes), log2 S
//      doublings and one add. Lanes exchange points through shared memory.
//      Longest chain of dependent point operations at B = 256:
//      13 + 5 + 5 + 3 + 1 = 27 (the running sum alone: 510). Bucket 0 has
//      weight 0 in both sums, whatever it holds.
//
//  (c) msm_combine: Horner over the windows, most significant first (8
//      doublings + 1 add a window), one warp per MSM. The 248 doublings
//      that carry the top window down are inherent, so a step is made
//      short instead: a point operation is a few rounds, and in a round
//      each of up to 6 lanes does one Fq operation of the RCB15 formulas
//      (their independent products side by side, b3 = 12 as an add chain),
//      passing values through shared memory: two dependent products a
//      point operation where one thread runs 8 (double) or 12 (add). The
//      rounds are a table that the wrapper passes in (ops/msm_rounds.py
//      holds the one schedule, and the CPU tests run the same table), so
//      the field values, and with them the limbs of the result, are those
//      of g1.cuh.
//
// (b) and (c) run few warps, so what a step costs is latency, instruction
// fetch included: their point and field operations are real calls (one
// copy of the Fq product in the instruction cache). K1 and (a) run many
// warps of independent adds and expand every product in place.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

// (a) msm_buckets: one block a row, BUCKET_THREADS threads, and the
// compiler's own register count (BUCKET_MIN_BLOCKS = 1: no cap, 8 warps an
// SM). Chosen by measurement (zkp_subnet_tpu_torch/kernel_ab.py over
// copies of the sources with that one choice changed; PERF.md has the
// times): capped at 128 registers for 16 warps the walk spills and runs
// slower, and so do other block shapes and an L1 prefetch of the next
// point.
constexpr int BUCKET_THREADS = 256;  // ops/msm.py:BUCKET_THREADS is its mirror
constexpr int BUCKET_MIN_BLOCKS = 1;
constexpr int BUCKETS = 256;  // a row's buckets: every value of a uint8 digit

// One block a row: the row's n digit-sorted entries in tiles of
// T = ceil(n / BUCKET_THREADS), thread t owning entries [tT, tT + T).
//  1. Every bucket of the row is set to infinity.
//  2. Walk: the thread sums each run of equal digits ≠ 0 in its tile with
//     one running sum (the run's first point, then adds in order) and
//     stores it to the run's bucket when the digit changes. A run wholly
//     inside the tile is then final. The tile's first run may have begun
//     in the tile before (a head piece H: stored now, finished in 4), its
//     last run may go on into the next (a piece V kept in registers): if
//     the whole tile is one such run, V covers the tile and continues a
//     run; otherwise V starts one.
//  3. A segmented inclusive scan of the V's across the block
//     (Hillis–Steele through shared memory, V_t = V_{t−d} + V_t while t's
//     segment reaches back past t − d; it stops when no segment is open):
//     V_t becomes the sum of its run's pieces up to tile t.
//  4. A thread with H adds V_{t−1} to it: the run's sum.
// No thread adds more than T − 1 points in its walk, whatever the digits,
// and the row's longest chain of dependent adds is T − 1 + log2(threads)
// + 1. Uniform digits do about n + BUCKET_THREADS adds a row; a row of one
// digit n + BUCKET_THREADS·log2(BUCKET_THREADS). Entries of digit 0 (and
// the glue's padding, which has digit 0) are never added.
// ops/msm.py:msm_buckets_plain does the same adds in the same order.
__global__ void __launch_bounds__(BUCKET_THREADS, BUCKET_MIN_BLOCKS)
msm_buckets_kernel(const uint32_t* __restrict__ points,
                   const int32_t* __restrict__ perm,
                   const uint8_t* __restrict__ digits,
                   uint32_t* __restrict__ buckets, int row_len) {
  __shared__ uint32_t sh[G1_WORDS * BUCKET_THREADS];
  __shared__ int sh_flag[BUCKET_THREADS];
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const int32_t* idx = perm + row * row_len;
  const uint8_t* dig = digits + row * row_len;
  uint32_t* out = buckets + G1_WORDS * row * BUCKETS;
  const int T = (row_len + BUCKET_THREADS - 1) / BUCKET_THREADS;
  const int s = min(t * T, row_len), e = min(s + T, row_len);

  G1 acc;
  g1_set_infinity(acc);
  for (int b = t; b < BUCKETS; b += BUCKET_THREADS)
    g1_store(out + G1_WORDS * b, acc);
  __syncthreads();

  int first = 0, cur = -1;
  bool open_left = false, open_right = false, single = false;
  if (s < e) {
    first = dig[s];
    const int last = dig[e - 1];
    open_left = first != 0 && s > 0 && dig[s - 1] == first;
    open_right = last != 0 && e < row_len && dig[e] == last;
    single = first == last;
  }
  for (int k = s; k < e; k++) {
    const int d = dig[k];
    const uint32_t* src = points + G1_WORDS * (long long)idx[k];
    if (d != cur) {
      if (cur > 0) g1_store(out + G1_WORDS * cur, acc);
      cur = d;
      if (d != 0) g1_load(acc, src);
    } else if (d != 0) {
      G1 P;
      g1_load(P, src);
      g1_add(acc, acc, P);
    }
  }
  const bool has_v = cur > 0 && open_right;
  if (cur > 0 && !open_right) g1_store(out + G1_WORDS * cur, acc);
  const bool has_h = open_left && !(single && open_right);
  // flag 1: V starts a segment (or there is no V); 0: V continues one
  int flag = !(has_v && single && open_left);

  for (int d = 1; d < BUCKET_THREADS; d *= 2) {
    if (!__syncthreads_or(!flag)) break;
    g1_store_shared<BUCKET_THREADS>(sh, t, acc);
    sh_flag[t] = flag;
    __syncthreads();
    if (!flag && t >= d) {
      G1 prev;
      g1_load_shared<BUCKET_THREADS>(prev, sh, t - d);
      flag = sh_flag[t - d];
      g1_add(acc, prev, acc);
    }
  }
  __syncthreads();
  g1_store_shared<BUCKET_THREADS>(sh, t, acc);
  __syncthreads();
  if (has_h) {
    G1 S, H;
    g1_load_shared<BUCKET_THREADS>(S, sh, t - 1);
    g1_load(H, out + G1_WORDS * first);
    g1_add(H, S, H);
    g1_store(out + G1_WORDS * first, H);
  }
}

// Fq operations as calls: operands anywhere (local or shared memory), one
// copy of each body in the program.
struct FqCall {
  static __device__ __noinline__ void mul(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b) {
    uint32_t x[fq::L], y[fq::L];
#pragma unroll
    for (int j = 0; j < fq::L; j++) { x[j] = a[j]; y[j] = b[j]; }
    fq::mul(x, x, y);
#pragma unroll
    for (int j = 0; j < fq::L; j++) r[j] = x[j];
  }
  static __device__ __noinline__ void sqr(uint32_t* r, const uint32_t* a) {
    uint32_t x[fq::L];
#pragma unroll
    for (int j = 0; j < fq::L; j++) x[j] = a[j];
    fq::sqr(x, x);
#pragma unroll
    for (int j = 0; j < fq::L; j++) r[j] = x[j];
  }
  static __device__ __noinline__ void add(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b) {
    uint32_t x[fq::L], y[fq::L];
#pragma unroll
    for (int j = 0; j < fq::L; j++) { x[j] = a[j]; y[j] = b[j]; }
    fq::add(x, x, y);
#pragma unroll
    for (int j = 0; j < fq::L; j++) r[j] = x[j];
  }
  static __device__ __noinline__ void sub(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b) {
    uint32_t x[fq::L], y[fq::L];
#pragma unroll
    for (int j = 0; j < fq::L; j++) { x[j] = a[j]; y[j] = b[j]; }
    fq::sub(x, x, y);
#pragma unroll
    for (int j = 0; j < fq::L; j++) r[j] = x[j];
  }
};

__device__ __noinline__ void g1_add_call(G1& R, const G1& P, const G1& Q) {
  g1_add_with<FqCall>(R, P, Q);
}

__device__ __noinline__ void g1_double_call(G1& R, const G1& P) {
  g1_double_with<FqCall>(R, P);
}

constexpr int REDUCE_THREADS = 128;
constexpr int REDUCE_SEGMENT = 8;  // ops/msm.py:REDUCE_SEGMENT is its mirror

// S buckets a lane, J = nbuckets / S lanes a row (a power of two in
// 2..REDUCE_THREADS), REDUCE_THREADS / J rows a block. ops/msm.py:
// msm_reduce_plain does the same adds in the same order.
__global__ void __launch_bounds__(REDUCE_THREADS)
msm_reduce_kernel(const uint32_t* __restrict__ buckets,
                  uint32_t* __restrict__ sums, int rows, int nbuckets) {
  constexpr int S = REDUCE_SEGMENT;
  __shared__ uint32_t sh[REDUCE_THREADS * G1_WORDS];
  const int J = nbuckets / S;
  const int h = J / 2;
  const int tid = threadIdx.x;
  const int lane = tid & (J - 1);
  long long row = blockIdx.x * (long long)(REDUCE_THREADS / J) + tid / J;
  const bool live = row < rows;
  if (!live) row = rows - 1;  // a spare group repeats the last row, so that
                              // every thread reaches every barrier
  uint32_t* mine = sh + G1_WORDS * tid;

  // the segment, top-down: run = S_j, T = T_j
  const uint32_t* seg = buckets + G1_WORDS * (row * nbuckets + lane * S);
  G1 run, T, B;
  g1_load(run, seg + G1_WORDS * (S - 1));
  T = run;
  for (int i = S - 2; i >= 1; i--) {
    g1_load(B, seg + G1_WORDS * i);
    g1_add_call(run, run, B);
    g1_add_call(T, T, run);
  }
  g1_load(B, seg);
  g1_add_call(run, run, B);

  // inclusive suffix scan of S_j over the row's lanes: run = sum_{k>=j} S_k
  for (int d = 1; d < J; d *= 2) {
    g1_store(mine, run);
    __syncthreads();
    if (lane + d < J) {
      g1_load(B, mine + G1_WORDS * d);
      g1_add_call(run, run, B);
    }
    __syncthreads();
  }

  // tree sums: entries 1..J-1 of the scan in the lower half of the lanes,
  // the T_j in the upper half
  if (lane == 0) g1_set_infinity(run);
  g1_store(mine, lane < h ? T : run);
  __syncthreads();
  g1_load(B, sh + G1_WORDS * (tid ^ h));
  if (lane >= h) run = T;
  g1_add_call(run, run, B);
  __syncthreads();
  for (int d = h / 2; d >= 1; d /= 2) {
    g1_store(mine, run);
    __syncthreads();
    if ((lane & (h - 1)) < d) {
      g1_load(B, mine + G1_WORDS * d);
      g1_add_call(run, run, B);
    }
    __syncthreads();
  }
  g1_store(mine, run);
  __syncthreads();
  if (lane == 0 && live) {
    for (int s = S; s > 1; s /= 2) g1_double_call(run, run);
    g1_load(B, mine + G1_WORDS * h);
    g1_add_call(run, run, B);
    g1_store(sums + G1_WORDS * row, run);
  }
}

// The only statement of the combine kernel's limits: zkp_msm_combine
// refuses a table that needs more.
constexpr int COMBINE_SLOTS = 48;   // Fq values a warp keeps in shared memory
constexpr int COMBINE_WORDS = 256;  // operations of both tables together

// One point operation: `rounds` rounds of the table, lane l < lanes doing
// operation l of each round. An operation is kind | a << 8 | b << 16 |
// dst << 24 with kind 0 none, 1 dst = a·b, 2 dst = a + b, 3 dst = a − b
// over the warp's slots.
__device__ __forceinline__ void run_rounds(uint32_t* slots,
                                           const uint32_t* ops, int rounds,
                                           int lanes, int lane) {
  for (int r = 0; r < rounds; r++) {
    const uint32_t op = lane < lanes ? ops[r * lanes + lane] : 0u;
    const uint32_t kind = op & 0xffu;
    if (kind != 0) {
      const uint32_t* a = slots + fq::L * ((op >> 8) & 0xffu);
      const uint32_t* b = slots + fq::L * ((op >> 16) & 0xffu);
      uint32_t* dst = slots + fq::L * (op >> 24);
      if (kind == 1) FqCall::mul(dst, a, b);
      else if (kind == 2) FqCall::add(dst, a, b);
      else FqCall::sub(dst, a, b);
    }
    __syncwarp();
  }
}

// One warp per chain. Slots 0..2 hold the accumulator (X, Y, Z), 3..5 the
// window sum being added; the table's first `double_rounds` rounds double
// the accumulator in place, the next `add_rounds` add slots 3..5 to it.
__global__ void __launch_bounds__(32)
msm_combine_kernel(const uint32_t* __restrict__ window_sums,
                   uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ program, int windows,
                   int window_bits, int double_rounds, int add_rounds,
                   int lanes) {
  __shared__ uint32_t slots[COMBINE_SLOTS * fq::L];
  __shared__ uint32_t ops[COMBINE_WORDS];
  const int lane = threadIdx.x;
  const uint32_t* sums =
      window_sums + (long long)G1_WORDS * windows * blockIdx.x;
  for (int j = lane; j < (double_rounds + add_rounds) * lanes; j += 32)
    ops[j] = program[j];
  for (int j = lane; j < G1_WORDS; j += 32)  // infinity (0 : 1 : 0)
    slots[j] = j / fq::L == 1 ? fq::ONE[j % fq::L] : 0u;
  __syncwarp();
  for (int w = windows - 1; w >= 0; w--) {
    for (int i = 0; i < window_bits; i++)
      run_rounds(slots, ops, double_rounds, lanes, lane);
    for (int j = lane; j < G1_WORDS; j += 32)
      slots[G1_WORDS + j] = sums[(long long)G1_WORDS * w + j];
    __syncwarp();
    run_rounds(slots, ops + double_rounds * lanes, add_rounds, lanes, lane);
  }
  for (int j = lane; j < G1_WORDS; j += 32)
    out[(long long)G1_WORDS * blockIdx.x + j] = slots[j];
}

}  // namespace

// perm (rows, row_len) int32 point indices and digits (rows, row_len) uint8
// in ascending digit order within each row; buckets (rows, 256, 3, 12).
extern "C" int zkp_msm_buckets(const void* points, const void* perm,
                               const void* digits, void* buckets, int rows,
                               int row_len, void* stream) {
  if (row_len < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0)
    msm_buckets_kernel<<<rows, BUCKET_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)points, (const int32_t*)perm,
        (const uint8_t*)digits, (uint32_t*)buckets, row_len);
  return (int)cudaGetLastError();
}

// nbuckets / REDUCE_SEGMENT must be a power of two in 2..REDUCE_THREADS.
extern "C" int zkp_msm_reduce(const void* buckets, void* sums, int rows,
                              int nbuckets, void* stream) {
  const int lanes = nbuckets / REDUCE_SEGMENT;
  if (lanes < 2 || lanes > REDUCE_THREADS || (lanes & (lanes - 1)) != 0 ||
      lanes * REDUCE_SEGMENT != nbuckets)
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const int rows_a_block = REDUCE_THREADS / lanes;
    const int blocks = (rows + rows_a_block - 1) / rows_a_block;
    msm_reduce_kernel<<<blocks, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buckets, (uint32_t*)sums, rows, nbuckets);
  }
  return (int)cudaGetLastError();
}

// `program` holds double_rounds + add_rounds rows of `lanes` operations
// over slots 0..slots-1.
extern "C" int zkp_msm_combine(const void* window_sums, void* out,
                               const void* program, int chains, int windows,
                               int window_bits, int double_rounds,
                               int add_rounds, int lanes, int slots,
                               void* stream) {
  if (double_rounds < 1 || add_rounds < 1 || lanes < 1 || lanes > 32 ||
      (double_rounds + add_rounds) * lanes > COMBINE_WORDS ||
      slots < 2 * 3 || slots > COMBINE_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (chains > 0)
    msm_combine_kernel<<<chains, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)window_sums, (uint32_t*)out,
        (const uint32_t*)program, windows, window_bits, double_rounds,
        add_rounds, lanes);
  return (int)cudaGetLastError();
}
