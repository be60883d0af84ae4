// K2: the Pippenger bucket machinery (8-bit windows) over G1 points.
//
// Replaces the XLA graph around pfield∘ZFQ in zkp_subnet_tpu/ops/msm.py:
// _chunk_bucket_sums (:202-300: sort, prefix scan, one-hot run-end
// matmuls, forward fill, bucket differences), _weighted_window_sums
// (:303-316) and the Horner sweep (:384-392). On Hopper a thread can walk
// a variable-length run, so the scan/one-hot machinery the TPU needed to
// stay branch-free is gone: each bucket is summed directly.
//
// Three kernels over the complete add/double of g1.cuh, all deterministic
// (no atomics, fixed order). A row is one window of one point group of one
// MSM; K MSMs over the same bases share every launch.
//
//  (a) msm_buckets: one thread per (row, bucket != 0) walks its sorted run
//      (the glue in ops/msm.py sorts each row's digits and computes run
//      starts and lengths) and adds the gathered points serially. Bucket 0
//      and empty buckets stay at infinity. Bound: integer multiplies (an
//      add is ~4,000 wide multiply-adds); at a 2^16 row with 8 point groups
//      it runs 8·32·255 threads of ~32 serial adds for each MSM.
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
//      point operation where one thread runs 9 (double) or 14 (add). The
//      rounds are a table that the wrapper passes in (ops/msm_rounds.py
//      holds the one schedule, and the CPU tests run the same table), so
//      the field values, and with them the limbs of the result, are those
//      of g1.cuh.
//
// (b) and (c) run few warps, so what a step costs is latency, instruction
// fetch included: their point and field operations are real calls (one
// copy of the Fq product in the instruction cache) where K1 and (a) expand
// every product in place.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

__global__ void __launch_bounds__(128)
msm_buckets_kernel(const uint32_t* __restrict__ points,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ counts,
                   uint32_t* __restrict__ buckets, int rows, int row_len,
                   int nbuckets) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (long long)rows * nbuckets) return;
  const int row = (int)(t / nbuckets);
  const int bucket = (int)(t % nbuckets);
  G1 acc;
  g1_set_infinity(acc);
  if (bucket != 0) {
    const int32_t* idx = perm + (long long)row * row_len + starts[t];
    const int n = counts[t];
    for (int k = 0; k < n; k++) {
      G1 P;
      g1_load(P, points + (long long)G1_WORDS * idx[k]);
      g1_add(acc, acc, P);
    }
  }
  g1_store(buckets + G1_WORDS * t, acc);
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

constexpr int THREADS = 128;

}  // namespace

extern "C" int zkp_msm_buckets(const void* points, const void* perm,
                               const void* starts, const void* counts,
                               void* buckets, int rows, int row_len,
                               int nbuckets, void* stream) {
  const long long n = (long long)rows * nbuckets;
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    msm_buckets_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)points, (const int32_t*)perm,
        (const int32_t*)starts, (const int32_t*)counts, (uint32_t*)buckets,
        rows, row_len, nbuckets);
  }
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
