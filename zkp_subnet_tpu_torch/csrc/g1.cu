// K1: elementwise complete G1 point add and double over (N, 3, 12) points.
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (reached
// through dispatch_ladd/dispatch_ldouble: 29 field-op launches compose one
// RCB15 add on the TPU) and, later, padd/pdouble/pfield over lane8.BFQ/pmul.
// Here one thread computes one whole add or double in registers: no field
// intermediate ever leaves the SM.
//
// Bound on the H100: integer multiply throughput, not bytes. An add reads
// 288 bytes and writes 144, but runs 14 Fq products of 2·144 32x32->64
// multiply-adds each (~4,000 wide multiplies). The design keeps every operand in
// registers and fully unrolls the limb loops so the multiplies issue back
// to back; one thread per point gives enough independent warps at the
// MSM's and the scalar multiplication's widths (N >= 2^15) to cover latency.
#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

__global__ void __launch_bounds__(128)
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

__global__ void __launch_bounds__(128)
g1_double_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P;
  g1_load(P, p + G1_WORDS * i);
  g1_double(P, P);
  g1_store(out + G1_WORDS * i, P);
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int zkp_g1_add(const void* p, const void* q, void* out,
                          long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    g1_add_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int zkp_g1_double(const void* p, void* out, long long n,
                             void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    g1_double_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
