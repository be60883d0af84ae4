// K3: elementwise Fr Montgomery multiply and add over (N, 8) elements, with
// one operand optionally broadcast (a single element, step 0).
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lane8.BFR as reached
// from poly._fmul/_fadd (zkp_subnet_tpu/ops/poly.py:37-47): the powers of
// x and 1/x, the termwise products, the Hillis-Steele suffix sums, the
// quotient scaling and the de-Montgomery multiply by 1 of one KZG opening.
//
// Bound on the H100: a multiply reads 64 bytes and writes 32 for 128 wide
// multiply-adds, so at 2^16 elements it is launch-latency bound (~µs of
// work); the Hillis-Steele suffix sum costs log2(N) launches of the add.
// The design keeps one element per thread in registers; a one-pass scan
// kernel that replaces the log2(N) launches is later work.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

__global__ void __launch_bounds__(256)
fr_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              uint32_t* __restrict__ out, long long n, int a_step,
              int b_step) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fr::L], y[fr::L], r[fr::L];
#pragma unroll
  for (int j = 0; j < fr::L; j++) {
    x[j] = a[i * a_step + j];
    y[j] = b[i * b_step + j];
  }
  fr::mul(r, x, y);
#pragma unroll
  for (int j = 0; j < fr::L; j++) out[i * fr::L + j] = r[j];
}

__global__ void __launch_bounds__(256)
fr_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              uint32_t* __restrict__ out, long long n, int a_step,
              int b_step) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fr::L], y[fr::L], r[fr::L];
#pragma unroll
  for (int j = 0; j < fr::L; j++) {
    x[j] = a[i * a_step + j];
    y[j] = b[i * b_step + j];
  }
  fr::add(r, x, y);
#pragma unroll
  for (int j = 0; j < fr::L; j++) out[i * fr::L + j] = r[j];
}

constexpr int THREADS = 256;

}  // namespace

// a_step / b_step: fr::L for a full operand, 0 for a broadcast single one.
extern "C" int zkp_fr_mul(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    fr_mul_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
        b_step);
  }
  return (int)cudaGetLastError();
}

extern "C" int zkp_fr_add(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    fr_add_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
        b_step);
  }
  return (int)cudaGetLastError();
}
