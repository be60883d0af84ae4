// K4: elementwise Fq Montgomery multiply, add and subtract over (N, 12)
// elements, fully reduced, with one operand optionally broadcast (a single
// element, step 0).
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lane8.BFQ (one fully
// reduced Fq mul/add/sub per launch, as OpPallasField through
// dispatch_padd/dispatch_pdouble) and _pmul1 -> pmul (the Fq Montgomery
// product per tile). On the TPU those launches compose the comb's point add;
// here the add stays whole in K1 (csrc/g1.cu), and these kernels serve the
// Fq arithmetic outside a point add: FQ.mont_mul/add/sub/neg on a CUDA
// tensor, g1_neg, and the on-curve check Y^2 Z = X^3 + 4 Z^3 of a generated
// SRS.
//
// Bound on the H100: a multiply reads 96 bytes and writes 48 for 2·12·12 =
// 288 wide multiply-adds; at 2^20 elements the bytes take ~45 µs and the
// multiplies about as long, and at the 2^16 widths of one worker row the
// launch latency dominates. One element per thread in registers, moved as
// three 16-byte words each way, limb loops unrolled.
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

enum Op { MUL, ADD, SUB };

template <Op OP>
__global__ void __launch_bounds__(256)
fq_binary_kernel(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                 long long n, int a_step, int b_step) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::L], y[fq::L], r[fq::L];
  mont::load<fq::L>(x, a + i * a_step);
  mont::load<fq::L>(y, b + i * b_step);
  if (OP == MUL) fq::mul(r, x, y);
  if (OP == ADD) fq::add(r, x, y);
  if (OP == SUB) fq::sub(r, x, y);
  mont::store<fq::L>(out + i * fq::L, r);
}

constexpr int THREADS = 256;

// a_step / b_step: fq::L for a full operand, 0 for a broadcast single one.
template <Op OP>
int launch(const void* a, const void* b, void* out, long long n, int a_step,
           int b_step, void* stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    fq_binary_kernel<OP><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, a_step,
        b_step);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zkp_fq_mul(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<MUL>(a, b, out, n, a_step, b_step, stream);
}

extern "C" int zkp_fq_add(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<ADD>(a, b, out, n, a_step, b_step, stream);
}

extern "C" int zkp_fq_sub(const void* a, const void* b, void* out,
                          long long n, int a_step, int b_step, void* stream) {
  return launch<SUB>(a, b, out, n, a_step, b_step, stream);
}
