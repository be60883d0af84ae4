// K1: elementwise complete G1 point add and double over (N, 3, 12) points.
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (reached
// through dispatch_ladd/dispatch_ldouble: 29 field-op launches compose one
// RCB15 add on the TPU) and _padd1 -> padd / _pdouble1 -> pdouble (a whole
// RCB15 add or double over lane8.BFQ per tile, the add of the fixed-base
// comb): the lazy and the fully reduced engines compute the same function,
// and fully reduced values have one representation, so one kernel serves
// both. g1_fixed_base_mul launches g1_add once per 8-bit window.
// Here one thread computes one whole add or double in registers: no field
// intermediate ever leaves the SM.
//
// Bound on the H100: integer multiply throughput, not bytes. An add reads
// 288 bytes and writes 144, but runs 12 Fq products of 2·144 32-bit
// multiply-adds each (b3 = 12 is an add chain, csrc/g1.cuh), ~4,100
// operations. The design: the field operations as the card's carry chains
// (csrc/mont.cuh), every operand in registers, and the add at <= 128
// registers a thread (__launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)), so
// that 16 warps share an SM to cover the chains' latency and 2^16 adds
// (512 blocks) fit the card's 132·4 block slots in one wave. Measured
// against 168 registers (12 warps) and no cap (202, 8 warps), and against
// the field operations as calls: all slower (zkp_subnet_tpu_torch/
// kernel_ab.py over copies of the sources with that one choice changed;
// PERF.md has the times).
//
// g1_scalar_mul_kernel: [k_i]P_i, the whole double-and-add ladder in one
// launch. Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ
// as reached through dispatch_ldouble/dispatch_ladd from
// zkp_subnet_tpu/ops/curve.py:g1_scalar_mul (a fori_loop of 256 doubles,
// adds and selects, one jitted program on the TPU; eagerly that was 512 K1
// launches and 512 selects). Bound: integer multiplies, 256 doubles and an
// add for each set bit of k, ~1.2 million 32-bit operations a point, and
// at a few points (the aggregation's 16) the latency of one thread's chain
// of 256 dependent steps. The design: one thread a point, acc and P in
// registers for the whole ladder (no point leaves the SM between steps),
// the double and add of g1.cuh with the carry chains of mont.cuh, the
// scalar read a word at a time from memory.
//
// g1_msm_fixed: K MSMs over the same M fixed bases in two launches, for the
// Pianist aggregation's C_y = sum y_i·L_i and W_y = sum q_i·L_i over the
// Lagrange-Y keys L_i (M = 16 or 256). Replaces pallas_g1.py:pfield over
// lazy8.ZFQ as reached through dispatch_ldouble/dispatch_ladd from the
// naive MSM of zkp_subnet_tpu/ops/msm.py:msm_auto (:589-598: a ladder a
// point, then a tree sum). Bound: the operations are those of one ladder
// a point (~M·256 doubles), which keep the card busy for microseconds at
// these M; what costs is the chain of dependent point operations, 256
// steps of a ladder in one thread (6.95 ms on an H100 at 256 points). The
// design cuts the chain: the bases are fixed, so a table D[i][w] =
// [2^(8w)]L_i, w < 32, is built once per SRS and device (g1_fixed_table:
// one thread a base, 248 doubles), and sum_i k_i·L_i = sum_{i,w}
// d_{i,w}·D[i][w] over the scalars' bytes d_{i,w}. Launch 1, grid
// (blocks, K): a thread a term (i, w) computes d·D[i][w] by an 8-bit
// double-and-add (7 doubles, an add a set bit), and each block of
// FIXED_THREADS consecutive terms sums them by a tree in shared memory;
// launch 2, one block an MSM, adds the blocks' partial sums by a tree (at
// most FIXED_THREADS of them: M <= FIXED_MAX_KEYS = 512, twice the
// aggregation's 256). The longest chain is 7 doubles
// + 8 adds + log2(32·M) adds (28 at M = 256) in place of ~384. The field
// operations are expanded in place (FqInline): as calls (FqCall, msm.cu's
// choice for its chains) the MSM ran 1.25x slower on an H100 (0.476
// against 0.382 ms at 256 keys; zkp_subnet_tpu_torch/kernel_ab.py over a
// copy with that one choice changed; PERF.md has the times).
// Deterministic: a fixed order of adds, which
// ops/msm.py:msm_fixed_plain repeats, so the two agree limb for limb.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int ADD_THREADS = 128;
constexpr int ADD_MIN_BLOCKS = 4;  // 65536 / (128·4) = 128 registers

__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
              uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P, Q;
  g1_load(P, p + G1_WORDS * i);
  g1_load(Q, q + G1_WORDS * i);
  g1_add(P, P, Q);
  g1_store(out + G1_WORDS * i, P);
}

constexpr int DOUBLE_THREADS = 128;

__global__ void __launch_bounds__(DOUBLE_THREADS)
g1_double_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P;
  g1_load(P, p + G1_WORDS * i);
  g1_double(P, P);
  g1_store(out + G1_WORDS * i, P);
}

constexpr int LADDER_THREADS = 128;

__global__ void __launch_bounds__(LADDER_THREADS)
g1_scalar_mul_kernel(const uint32_t* __restrict__ p,
                     const uint32_t* __restrict__ scalars,
                     uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P;
  g1_load(P, p + G1_WORDS * i);
  g1_scalar_mul(P, P, scalars + 8 * i);
  g1_store(out + G1_WORDS * i, P);
}

constexpr int FIXED_WINDOWS = 32;  // 8-bit windows of a 256-bit scalar
constexpr int FIXED_BITS = 8;
// terms a block of launch 1 sums, and the most threads of launch 2;
// ops/msm.py:FIXED_THREADS is its mirror
constexpr int FIXED_THREADS = 128;
// keys at most: launch 1's blocks fit one block of launch 2
constexpr int FIXED_MAX_KEYS = FIXED_THREADS * FIXED_THREADS / FIXED_WINDOWS;

// table[i][w] = [2^(8w)]P_i for w < FIXED_WINDOWS: one thread a point, a
// store every 8 doubles.
__global__ void __launch_bounds__(LADDER_THREADS)
g1_fixed_table_kernel(const uint32_t* __restrict__ p,
                      uint32_t* __restrict__ table, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P;
  g1_load(P, p + G1_WORDS * i);
  uint32_t* row = table + G1_WORDS * FIXED_WINDOWS * i;
  g1_store(row, P);
#pragma unroll 1
  for (int w = 1; w < FIXED_WINDOWS; w++) {
#pragma unroll 1
    for (int b = 0; b < FIXED_BITS; b++) g1_double(P, P);
    g1_store(row + G1_WORDS * w, P);
  }
}

// Launch 1. Term j < terms = 32·M of MSM k = blockIdx.y is D = table[j]
// (point i = j / 32, window w = j % 32) times the byte j of the MSM's
// scalars (byte w of k_i, little-endian). A thread's term from infinity:
// for the digit's bits b = 7..0, a double (none at b = 7) and an add of D
// where b is set. Terms past the end are infinity. The block's tree: at
// step s = FIXED_THREADS/2 .. 1, thread t < s adds the point of t + s to
// its own. partial[k][blockIdx.x] = the block's sum.
__global__ void __launch_bounds__(FIXED_THREADS)
g1_msm_fixed_kernel(const uint32_t* __restrict__ table,
                    const uint8_t* __restrict__ digits,
                    uint32_t* __restrict__ partial, int terms) {
  __shared__ uint32_t sh[G1_WORDS * FIXED_THREADS];
  const int t = threadIdx.x;
  const long long j = blockIdx.x * (long long)FIXED_THREADS + t;
  G1 acc, Q;
  g1_set_infinity(acc);
  if (j < terms) {
    g1_load(Q, table + G1_WORDS * j);
    const uint32_t d = digits[(long long)blockIdx.y * terms + j];
#pragma unroll 1
    for (int b = FIXED_BITS - 1; b >= 0; b--) {
      if (b != FIXED_BITS - 1) g1_double(acc, acc);
      if ((d >> b) & 1) g1_add(acc, acc, Q);
    }
  }
  g1_store_shared<FIXED_THREADS>(sh, t, acc);
  __syncthreads();
#pragma unroll 1
  for (int s = FIXED_THREADS / 2; s >= 1; s /= 2) {
    if (t < s) {
      g1_load_shared<FIXED_THREADS>(Q, sh, t + s);
      g1_add(acc, acc, Q);
      g1_store_shared<FIXED_THREADS>(sh, t, acc);
    }
    __syncthreads();
  }
  if (t == 0)
    g1_store(partial + G1_WORDS * ((long long)blockIdx.y * gridDim.x +
                                   blockIdx.x),
             acc);
}

// Launch 2: one block of n threads (the power of two >= parts, parts <=
// FIXED_THREADS) an MSM. Thread t takes partial t (infinity past the end);
// then the tree of launch 1 over the n.
__global__ void __launch_bounds__(FIXED_THREADS)
g1_msm_fixed_sum_kernel(const uint32_t* __restrict__ partial,
                        uint32_t* __restrict__ out, int parts) {
  __shared__ uint32_t sh[G1_WORDS * FIXED_THREADS];
  const int t = threadIdx.x, n = blockDim.x;
  const uint32_t* mine = partial + G1_WORDS * (long long)blockIdx.x * parts;
  G1 acc, Q;
  if (t < parts)
    g1_load(acc, mine + G1_WORDS * t);
  else
    g1_set_infinity(acc);
  g1_store_shared<FIXED_THREADS>(sh, t, acc);
  __syncthreads();
#pragma unroll 1
  for (int s = n / 2; s >= 1; s /= 2) {
    if (t < s) {
      g1_load_shared<FIXED_THREADS>(Q, sh, t + s);
      g1_add(acc, acc, Q);
      g1_store_shared<FIXED_THREADS>(sh, t, acc);
    }
    __syncthreads();
  }
  if (t == 0) g1_store(out + G1_WORDS * (long long)blockIdx.x, acc);
}

}  // namespace

extern "C" int zkp_g1_add(const void* p, const void* q, void* out,
                          long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + ADD_THREADS - 1) / ADD_THREADS;
    g1_add_kernel<<<(unsigned)blocks, ADD_THREADS, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int zkp_g1_double(const void* p, void* out, long long n,
                             void* stream) {
  if (n > 0) {
    const long long blocks = (n + DOUBLE_THREADS - 1) / DOUBLE_THREADS;
    g1_double_kernel<<<(unsigned)blocks, DOUBLE_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// scalars: (n, 8) canonical 32-bit words, little-endian.
extern "C" int zkp_g1_scalar_mul(const void* p, const void* scalars,
                                 void* out, long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
    g1_scalar_mul_kernel<<<(unsigned)blocks, LADDER_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)scalars, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// table: (n, FIXED_WINDOWS, 3, 12).
extern "C" int zkp_g1_fixed_table(const void* p, void* table, long long n,
                                  void* stream) {
  if (n > 0) {
    const long long blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
    g1_fixed_table_kernel<<<(unsigned)blocks, LADDER_THREADS, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)table, n);
  }
  return (int)cudaGetLastError();
}

// table (m, FIXED_WINDOWS, 3, 12) from g1_fixed_table; scalars (k, m, 8)
// canonical 32-bit words (read as k rows of 32·m digit bytes); partial
// (k, ceil(32·m / FIXED_THREADS), 3, 12) scratch; out (k, 3, 12). windows,
// threads: the caller's FIXED_WINDOWS and FIXED_THREADS, refused unless
// they are these; m at most FIXED_MAX_KEYS.
extern "C" int zkp_g1_msm_fixed(const void* table, const void* scalars,
                                void* partial, void* out, int k, int m,
                                int windows, int threads, void* stream) {
  if (windows != FIXED_WINDOWS || threads != FIXED_THREADS || k < 1 ||
      k > 65535 || m < 1 || m > FIXED_MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  const int terms = FIXED_WINDOWS * m;
  const int parts = (terms + FIXED_THREADS - 1) / FIXED_THREADS;
  int n = 1;
  while (n < parts) n *= 2;
  g1_msm_fixed_kernel<<<dim3((unsigned)parts, (unsigned)k), FIXED_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint8_t*)scalars, (uint32_t*)partial,
      terms);
  g1_msm_fixed_sum_kernel<<<(unsigned)k, n, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, (uint32_t*)out, parts);
  return (int)cudaGetLastError();
}
