// BLS12-381 scalar field Fr on 8 x u32 limbs, Montgomery form, R = 2^256.
// R equals the JAX package's (16 x 16-bit limbs), so device values repack
// bit for bit (zkp_subnet_tpu/ops/field.py:362-364).
#pragma once

#include "mont.cuh"

namespace fr {

constexpr int L = 8;
constexpr uint32_t INV = 0xffffffffu;  // -r^(-1) mod 2^32

static __constant__ uint32_t P[L] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::mul<L>(r, a, b, P, INV);
}

__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::add<L>(r, a, b, P);
}

}  // namespace fr
