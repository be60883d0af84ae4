// K2: the Pippenger bucket machinery (8-bit windows) over G1 points.
//
// Replaces the XLA graph around pfield∘ZFQ in zkp_subnet_tpu/ops/msm.py:
// _chunk_bucket_sums (:202-300: sort, prefix scan, one-hot run-end
// matmuls, forward fill, bucket differences), _weighted_window_sums
// (:303-316) and the Horner sweep (:384-392). On Hopper a thread can walk
// a variable-length run, so the scan/one-hot machinery the TPU needed to
// stay branch-free is gone: each bucket is summed directly.
//
// Three kernels, all reusing the complete add/double of g1.cuh:
//  (a) msm_buckets: one thread per (row, bucket != 0) walks its sorted run
//      (the glue in ops/msm.py sorts each row's digits and computes run
//      starts and lengths) and adds the gathered points serially. A row is
//      one window of one point group. Bucket 0 and empty buckets stay at
//      infinity. Deterministic: no atomics, fixed order.
//  (b) msm_reduce: one thread per row computes sum_d d·B_d by the running
//      sum (2·255 adds).
//  (c) msm_combine: one thread runs Horner over the windows, most
//      significant first (8 doublings + 1 add per window).
//
// Bound on the H100: integer multiply throughput inside the point adds
// (~4,000 wide multiplies each), and here above all parallelism. At one
// 2^16 row with 8 point groups, (a) runs 8·32·255 = 65,280 threads of ~32
// serial adds; without groups 32·255 = 8,160 threads would underfill the
// 132 SMs (about two warps per SM). (b) runs only 256 threads and (c) one,
// so their serial chains of adds are latency-bound. Splitting long runs and
// a parallel bucket reduction are later work.
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

__global__ void __launch_bounds__(128)
msm_reduce_kernel(const uint32_t* __restrict__ buckets,
                  uint32_t* __restrict__ sums, int rows, int nbuckets) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  G1 running, total;
  g1_set_infinity(running);
  g1_set_infinity(total);
  const uint32_t* base = buckets + (long long)G1_WORDS * row * nbuckets;
  for (int d = nbuckets - 1; d >= 1; d--) {
    G1 B;
    g1_load(B, base + (long long)G1_WORDS * d);
    g1_add(running, running, B);   // sum_{e >= d} B_e
    g1_add(total, total, running);
  }
  g1_store(sums + (long long)G1_WORDS * row, total);
}

__global__ void msm_combine_kernel(const uint32_t* __restrict__ window_sums,
                                   uint32_t* __restrict__ out, int windows,
                                   int window_bits) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  G1 acc;
  g1_set_infinity(acc);
  for (int w = windows - 1; w >= 0; w--) {
    for (int i = 0; i < window_bits; i++) g1_double(acc, acc);
    G1 S;
    g1_load(S, window_sums + (long long)G1_WORDS * w);
    g1_add(acc, acc, S);
  }
  g1_store(out, acc);
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

extern "C" int zkp_msm_reduce(const void* buckets, void* sums, int rows,
                              int nbuckets, void* stream) {
  if (rows > 0) {
    const int blocks = (rows + THREADS - 1) / THREADS;
    msm_reduce_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)buckets, (uint32_t*)sums, rows, nbuckets);
  }
  return (int)cudaGetLastError();
}

extern "C" int zkp_msm_combine(const void* window_sums, void* out,
                               int windows, int window_bits, void* stream) {
  msm_combine_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)window_sums, (uint32_t*)out, windows, window_bits);
  return (int)cudaGetLastError();
}
