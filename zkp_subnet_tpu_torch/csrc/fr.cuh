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

// R mod r: the Montgomery one.
static __constant__ uint32_t ONE[L] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

// 2^514 mod r: the last product of inv (see there).
static __constant__ uint32_t INV_FIX[L] = {
    0xcfca71b4u, 0x2667a643u, 0x1e49708fu, 0xadb3b72eu,
    0xc950e63cu, 0x174c5259u, 0x7d67fc44u, 0x1d236766u};
// The largest j with 2^j < r.
constexpr int INV_TOP_BIT = 254;

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

__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < L; j++) r[j] = a[j];
}

__device__ __forceinline__ bool is_zero(const uint32_t* a) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < L; j++) any |= a[j];
  return any == 0;
}

// Trailing zero bits of a word that is not 0.
__device__ __forceinline__ int ctz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// The low word of (hi:lo) >> t and the high word of (hi:lo) << t, for
// 0 <= t < 32: one funnel shift each on the card.
__device__ __forceinline__ uint32_t funnel_right(uint32_t lo, uint32_t hi,
                                                 int t) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, t);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> t);
#endif
}

__device__ __forceinline__ uint32_t funnel_left(uint32_t lo, uint32_t hi,
                                                int t) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, t);
#else
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << t) >> 32);
#endif
}

// x >>= z and y <<= z for the z trailing zero bits of x (x != 0, and y
// small enough that nothing leaves its top); returns z. Whole words first,
// then the rest; every index is static, so x and y stay in registers.
__device__ __forceinline__ int shift_out_twos(uint32_t* x, uint32_t* y) {
  int z = 0;
  while (x[0] == 0) {
#pragma unroll
    for (int j = 0; j < L - 1; j++) x[j] = x[j + 1];
    x[L - 1] = 0;
#pragma unroll
    for (int j = L - 1; j > 0; j--) y[j] = y[j - 1];
    y[0] = 0;
    z += 32;
  }
  const int t = ctz32(x[0]);
#pragma unroll
  for (int j = 0; j < L - 1; j++) x[j] = funnel_right(x[j], x[j + 1], t);
  x[L - 1] >>= t;
#pragma unroll
  for (int j = L - 1; j > 0; j--) y[j] = funnel_left(y[j - 1], y[j], t);
  y[0] <<= t;
  return z + t;
}

// r = a + b as 256-bit integers (the caller knows there is no carry out).
__device__ __forceinline__ void add_wide(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < L - 1; j++) r[j] = ptx::addc_cc(a[j], b[j]);
  r[L - 1] = ptx::addc(a[L - 1], b[L - 1]);
}

// r = a - b mod 2^256; returns all ones where a < b, else 0.
__device__ __forceinline__ uint32_t sub_wide(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b) {
  r[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < L; j++) r[j] = ptx::subc_cc(a[j], b[j]);
  return ptx::subc(0, 0);
}

// out = 1/a in Montgomery form (a = xR gives x^(-1)R), 0 for a = 0.
// VARIABLE TIME: the steps taken depend on the value of a. Hand it public
// values only (the port's callers: an opening's point and the aggregation's
// differences beta - w^i); never a secret such as the SRS's trapdoor.
//
// Kaliski's almost Montgomery inverse (IEEE Trans. Computers 44(8), 1995)
// as a binary extended Euclid on the limbs: from u = r, v = a, s = 1, z = 0
// it keeps r = u·s + v·z with u and v odd, and each step subtracts the
// smaller of u, v from the larger, adds the two cofactors, and shifts the
// trailing zeros of the difference out of it and into the other cofactor,
// k counting the bits shifted. It ends at u = v = 1 with
// x = a^(-1)·2^k mod r, 255 <= k <= 510 (each bit comes off u or v).
// ~180 steps of a few carry chains and shifts each, in place of
// Fermat's 417 dependent products. Then a^(-1)R = x·2^(512-k), for a = xR
// in Montgomery form (the inverse of aR is wanted times R²): two Montgomery
// products, by 2^j with j = 510 - k (after one doubling of x where
// j = 255, so that 2^j < r) and by 2^514 mod r: x·2^j·2^514·2^(-512).
// out may alias a.
__device__ __forceinline__ void inv(uint32_t* out, const uint32_t* a) {
  if (is_zero(a)) {
#pragma unroll
    for (int j = 0; j < L; j++) out[j] = 0;
    return;
  }
  uint32_t u[L], v[L], s[L], z[L], d[L], e[L];
#pragma unroll
  for (int j = 0; j < L; j++) {
    u[j] = P[j];
    v[j] = a[j];
    s[j] = j == 0;
    z[j] = 0;
  }
  int k = shift_out_twos(v, z);
  // A step without branches but the last, so that the lanes of a warp
  // (the aggregation's M differences) stay together. Where v > u the pairs
  // (u, s) and (v, z) trade places first, by selects, so that the step
  // is always Kaliski's u > v one; r = u·s + v·z holds either way, and
  // `swapped` records the parity of the trades. On an H100 (PERF.md,
  // zkp_subnet_tpu_torch/kernel_ab.py over copies) one element took
  // 0.0237 ms this way, 0.0301 with a branch a step (0.0879 for 16 lanes
  // that diverge) and 0.0345 with selects of all four values a step.
  uint32_t swapped = 0;
#pragma unroll 1
  while (true) {
    const uint32_t u_below = sub_wide(d, u, v);  // all ones where u < v
    sub_wide(e, v, u);
    if (is_zero(d)) break;  // u = v = 1
#pragma unroll
    for (int j = 0; j < L; j++) {
      const uint32_t t = s[j];
      v[j] = u_below ? u[j] : v[j];  // the smaller
      d[j] = u_below ? e[j] : d[j];  // the larger less the smaller
      s[j] = u_below ? z[j] : t;
      z[j] = u_below ? t : z[j];
    }
    swapped ^= u_below;
    add_wide(z, z, s);
    k += shift_out_twos(d, s);
    copy(u, d);
  }
  // The last step, u = v = 1: a·s = 2^k and a·z = -2^k for the pairs as
  // Kaliski keeps them, so x = a^(-1)·2^(k+1) is 2z where they traded
  // places an odd number of times, else r - 2z.
#pragma unroll
  for (int j = L - 1; j > 0; j--) z[j] = (z[j] << 1) | (z[j - 1] >> 31);
  z[0] <<= 1;
  k++;
  mont::reduce_once<L>(z, z, P);  // 2z < 2r
  sub_wide(d, P, z);
#pragma unroll
  for (int j = 0; j < L; j++) d[j] = swapped ? z[j] : d[j];
  int j = 510 - k;
  if (j > INV_TOP_BIT) {
    add(d, d, d);
    j--;
  }
  uint32_t t[L];
#pragma unroll
  for (int w = 0; w < L; w++) t[w] = w == (j >> 5) ? 1u << (j & 31) : 0u;
  mul(d, d, t);
  mul(out, d, INV_FIX);
}

// -- Horner's steps: K3 fr_eval_rows --------------------------------------
//
// h = h·X + c: one step of a thread's Horner run over the coefficients it
// takes at a stride s from the top down, X = x^s (fr_eval_rows: s = 32
// over a warp's lanes, s = 32 tiles over a row's tiles), so that a run of
// m steps from h = c_(m-1) gives Σ_e c_e·X^e. h is kept below 2r, not
// reduced: the product reads h as the operand whose words it scans, which
// may be any 256-bit value (mont::mul's sums stay below X + r < 2r), and
// is below r, so h·X + c < 2r < 2^256 is one carry chain. A product with h
// in the same place, or one conditional subtract, brings it below r.
__device__ __forceinline__ void horner_step(uint32_t* h, const uint32_t* X,
                                            const uint32_t* c) {
  mul(h, X, h);
  add_wide(h, h, c);
}

// r = a + xd·b: a step of the tree that joins the values of two runs that
// start d apart, xd = x^d (fr_eval_rows: a tile's warps, d = 4, 2, 1 runs
// of a warp). r may alias a or b.
__device__ __forceinline__ void tree_step(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const uint32_t* xd) {
  uint32_t t[L];
  mul(t, b, xd);
  add(r, a, t);
}

// -- power tables: K3 fr_power_tables builds them, fr_powers and
// fr_open_quotient read them -------------------------------------------------
//
// The kernels' level width: 2^8 entries, so 2^16 powers take two levels.
constexpr int POW_LEVEL_BITS = 8;
constexpr int POW_WIDTH = 1 << POW_LEVEL_BITS;

// A table of `levels` levels of W = 2^WB entries: T[l·W + i] = x^(i·W^l),
// so that x^e for e < W^levels is the product of one entry a level, the
// entry of e's digit l (base W) in level l. A block of W threads builds it,
// thread i entry i of every level.

// The level of `base` for thread i: v = base^i by a Hillis-Steele product
// scan over (1, base, base, ...), WB dependent products, one barrier
// (`sync`) each, through two buffers of W elements in S used in turn: a
// step writes its buffer and reads it after the barrier, and the buffer it
// writes was last read two steps before, behind that step's barrier.
template <int WB, class Sync>
__device__ __forceinline__ void level_scan(uint32_t* v, uint32_t* S,
                                           const uint32_t* base, int i,
                                           Sync sync) {
  constexpr int W = 1 << WB;
  copy(v, i == 0 ? ONE : base);
#pragma unroll 1
  for (int s = 0; s < WB; s++) {
    uint32_t* buf = S + (s & 1) * W * L;
    mont::store<L>(buf + i * L, v);
    sync();
    const int d = 1 << s;
    if (i >= d) {
      uint32_t t[L];
      mont::load<L>(t, buf + (i - d) * L);
      mul(v, v, t);
    }
  }
}

// The whole table of x for thread i of W: level after level, each by
// level_scan; the next level's base x^(W^(l+1)) is the last entry times the
// base, from thread W - 1 through the slot S[2W] and one barrier. S holds
// 2W + 1 elements. canonical0: level 0 is stored times the integer 1, out of
// Montgomery form (x^i itself), so that a lookup's product by it gives a
// canonical power (the quotient's powers of 1/x, which it writes
// canonical); the levels above stay Montgomery. The chain: levels·(WB + 1)
// dependent products.
template <int WB, class Sync>
__device__ __forceinline__ void power_table(uint32_t* T, uint32_t* S,
                                            const uint32_t* x, int levels,
                                            bool canonical0, int i,
                                            Sync sync) {
  constexpr int W = 1 << WB;
  uint32_t b[L], v[L];
  copy(b, x);
#pragma unroll 1
  for (int l = 0; l < levels; l++) {
    level_scan<WB>(v, S, b, i, sync);
    if (l + 1 < levels) {
      if (i == W - 1) {
        uint32_t t[L];
        mul(t, v, b);
        mont::store<L>(S + 2 * W * L, t);
      }
      sync();
      mont::load<L>(b, S + 2 * W * L);
    }
    if (l == 0 && canonical0) {
      uint32_t one[L] = {1};
      mul(v, v, one);
    }
    mont::store<L>(T + ((long long)l * W + i) * L, v);
  }
}

// r = x^e from x's table of `levels` levels (e < W^levels): the entry of
// e's lowest digit times the entry of each digit above it, levels - 1
// products. Canonical where level 0 is (a canonical value times Montgomery
// ones stays canonical), else Montgomery.
template <int WB>
__device__ __forceinline__ void table_pow(uint32_t* r, const uint32_t* T,
                                          unsigned long long e, int levels) {
  constexpr int W = 1 << WB;
  mont::load<L>(r, T + (e & (W - 1)) * L);
#pragma unroll 1
  for (int l = 1; l < levels; l++) {
    uint32_t t[L];
    mont::load<L>(t, T + ((long long)l * W + ((e >> (l * WB)) & (W - 1))) * L);
    mul(r, r, t);
  }
}

}  // namespace fr
