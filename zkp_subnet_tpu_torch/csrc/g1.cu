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
