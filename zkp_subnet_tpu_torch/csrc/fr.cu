// K3: elementwise Fr Montgomery multiply, add and subtract over (N, 8)
// elements, with one operand optionally broadcast (a single element, step 0).
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lane8.BFR as reached
// from poly._fmul/_fadd (zkp_subnet_tpu/ops/poly.py:37-47) and ntt._f8
// (zkp_subnet_tpu/ops/ntt.py:136-143): the powers of x and 1/x, the termwise
// products, the Hillis-Steele suffix sums, the quotient scaling and the
// de-Montgomery multiply by 1 of one KZG opening; the 1/n scaling of the
// inverse NTT; the differences, inverses and barycentric sum of the Pianist
// aggregation.
//
// Bound on the H100: a multiply reads 64 bytes and writes 32 for 128 wide
// multiply-adds, so at 2^16 elements it is launch-latency bound (~µs of
// work); the Hillis-Steele suffix sum costs log2(N) launches of the add.
// The design keeps one element per thread in registers (moved as two
// 16-byte words each way); a one-pass scan kernel that replaces the log2(N)
// launches is later work.
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
