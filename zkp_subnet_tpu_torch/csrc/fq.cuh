// BLS12-381 base field Fq on 12 x u32 limbs, Montgomery form, R = 2^384.
// R equals the JAX package's (24 x 16-bit limbs), so device values repack
// bit for bit (zkp_subnet_tpu/ops/field.py:365-367).
#pragma once

#include "mont.cuh"

namespace fq {

constexpr int L = 12;
constexpr uint32_t INV = 0xfffcfffdu;  // -q^(-1) mod 2^32

static __constant__ uint32_t P[L] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

// R mod q: the Montgomery one (Y of the point at infinity).
static __constant__ uint32_t ONE[L] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

__device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::mul<L>(r, a, b, P, INV);
}

// r = a·a (Montgomery): mul(r, a, a)'s value from fewer limb products.
__device__ __forceinline__ void sqr(uint32_t* r, const uint32_t* a) {
  mont::sqr<L>(r, a, P, INV);
}

__device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::add<L>(r, a, b, P);
}

__device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                    const uint32_t* b) {
  mont::sub<L>(r, a, b, P);
}

}  // namespace fq
