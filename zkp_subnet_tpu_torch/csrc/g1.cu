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
// The double (g1_double_kernel): the same kind of bound (6 Fq products
// and 2 squares, ~2,500 operations) and a thread a double at 128
// registers, with two changes that each measured faster on the H100: the
// point moved as nine 16-byte words each way by g1_load16/g1_store16
// (the parent's 4-byte loads fell 144 bytes apart across a warp: this
// halved the time) and Y² and Z² by fq::sqr (mont::sqr: 78
// limb products where a product has 144, the reduction's 144 alike; ~5%
// here and in the ladder's thread form). Measured against the point split
// over 2 lanes (a squaring and a product a lane a step, the squares and a
// product swapped by shuffles) and 4 (a product a lane a step): faster at
// one wave of the card (2^16 points) and at 16, slower from several waves
// (2^20), where the split's repeated additions cost instructions; and
// against the products taken in pairs, their rows in turns (spills, and
// slower).
//
// g1_scalar_mul: [k_i]P_i, the whole ladder in one launch. Replaces
// zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ as reached through
// dispatch_ldouble/dispatch_ladd from zkp_subnet_tpu/ops/curve.py:
// g1_scalar_mul (a fori_loop of 256 doubles, adds and selects, one jitted
// program on the TPU). The naive MSM (ops/msm.py, at most 2048 points a
// row) runs it over every product of a call: a worker's commit and opening
// of a 1024-coefficient row are 2048 ladders, a one-rank prove at the
// default 18/8 is 2^19. Bound: integer multiplies (bitlen(k) − 1 doubles and
// the adds of the best fixed window, ~1 million 32-bit operations a point),
// and, at a few thousand points, the latency of one point's chain of
// dependent operations. The design shortens that chain and each of its
// steps, with one order of operations for both of its forms (g1.cuh, "the
// ladder"):
//  (1) signed windows of LADDER_DIGIT_BITS = 4 bits, digits in [-7, 8]
//      recoded on the card (signed_digit) and a table P … 8P a point, built
//      in the kernel: 252 doubles and at most 64 adds a point in place of
//      the binary method's 255 and ~128, and 7 operations for the table;
//      a carry out of the top window makes every 256-bit k exact;
//  (2) the group form (g1_scalar_mul_group_kernel), for few points: a
//      point a group of 8 lanes, each step's independent Fq products side
//      by side on its lanes (group_double, group_add_sh: two products in a
//      row a step, where one thread has eight or twelve), the table, acc
//      and the products in shared memory for the whole ladder;
//  (3) the thread form (g1_scalar_mul_kernel), for many points: a thread a
//      point, acc in registers and the table in the thread's local memory,
//      no lane computing a product that is thrown away (a group's double
//      keeps 4 of its 8 lanes busy).
// The wrapper picks the form by the number of points, at the crossover
// measured on the card (ops/kernels.py:LADDER_GROUP_MAX). Measured against
// 5-bit windows (zkp_subnet_tpu_torch/kernel_ab.py; PERF.md has the
// times).
//
// g1_fixed_table and g1_msm_fixed: K MSMs over the same M fixed bases, any
// M >= 1, for the Pianist aggregation's C_y = sum y_i·L_i and W_y = sum
// q_i·L_i over the Lagrange-Y keys L_i of every challenge. Replaces
// pallas_g1.py:pfield over lazy8.ZFQ as reached through dispatch_ldouble/
// dispatch_ladd from the naive MSM of zkp_subnet_tpu/ops/msm.py:msm_auto
// (:589-598: a ladder a point, then a tree sum). Bound on this card: few
// operations (buckets over a window table, an add a nonzero term: ~4 us
// of the integer rate at 256 keys and 2 MSMs), but long chains of dependent
// point operations, and one thread takes ~13 us for each (12 products in a
// row). So the design shortens both the chains and each of their steps:
//  (1) a step's independent Fq products run side by side on the lanes of
//      a group (group_double, group_add_sh below), the values between the
//      steps passed through shared memory: two products in a row a step,
//      where one thread has eight (double) or twelve (add);
//  (2) the table, once per SRS and device: D[i][w][m] = [(m+1)·16^w]L_i for
//      64 windows of 4 bits and the 8 multiples a signed digit in [-7, 8]
//      needs (73,728 bytes a key). The first launch of g1_fixed_table
//      doubles each key 255 times in a row, a group of TABLE_LANES lanes a
//      key, storing each window's B, 2B, 4B and 8B on the way; the second,
//      a thread an entry, makes 3B, 5B, 6B and 7B by one add each;
//  (3) an MSM is then a plain sum of 64·M terms, each one table entry
//      (negated for a negative digit, infinity for 0): no doubles. The sum
//      is a tree of launches. A block of FIXED_GROUPS groups of FIXED_LANES
//      lanes sums FIXED_FAN_IN = 32 consecutive inputs by a halving tree
//      (at s = 16, 8, ..., 1 group g < s adds entry g + s to its own, the
//      points in shared memory, a short last block padded with infinity to
//      its power of two); the first launch's inputs are the terms (its
//      lanes find their terms' signed digits in the scalars), each later
//      launch's the block sums of the one before, until one is left: about
//      log2(64·M) dependent adds (14 at M = 256, 16 at 1024) in
//      ceil(log32(64·M)) launches, no block of any launch holding more than
//      32 inputs, so no limit on M.
// Measured against other forms of the same trees (each step as
// msm_combine's table of rounds over Fq values in shared memory; the points
// in every lane's registers; 16 or 64 inputs a block): each slower at 16,
// 256 or 1024 keys (zkp_subnet_tpu_torch/kernel_ab.py; PERF.md has the
// times).
// Deterministic: a fixed order of adds, which ops/msm.py:fixed_table_plain
// and msm_fixed_plain repeat, so kernels and plain versions agree limb for
// limb.
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
constexpr int DOUBLE_MIN_BLOCKS = 4;  // 128 registers, as the add

// A thread a double, the point moved as 16-byte words (g1_load16).
__global__ void __launch_bounds__(DOUBLE_THREADS, DOUBLE_MIN_BLOCKS)
g1_double_kernel(const uint32_t* __restrict__ p, uint32_t* __restrict__ out,
                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  G1 P;
  g1_load16(P, p + G1_WORDS * i);
  g1_double(P, P);
  g1_store16(out + G1_WORDS * i, P);
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

constexpr int FIXED_DIGIT_BITS = 4;  // signed digits in [-7, 8]
constexpr int FIXED_WINDOWS = 256 / FIXED_DIGIT_BITS;
constexpr int FIXED_MULTIPLES = 1 << (FIXED_DIGIT_BITS - 1);
// the table's chain: TABLE_LANES lanes a key (the double's products a
// step), TABLE_KEYS keys a block of one warp
constexpr int TABLE_LANES = 4;
constexpr int TABLE_KEYS = 32 / TABLE_LANES;
// the MSM's tree: FIXED_LANES lanes an add (6 take its products a step),
// FIXED_GROUPS adds side by side, FIXED_FAN_IN inputs a block;
// ops/kernels.py:FIXED_FAN_IN is its mirror
constexpr int FIXED_LANES = 8;
constexpr int FIXED_GROUPS = 16;
constexpr int FIXED_FAN_IN = 2 * FIXED_GROUPS;
constexpr int FIXED_THREADS = FIXED_LANES * FIXED_GROUPS;

// -- point operations split over the lanes of a group -----------------------
//
// A group of consecutive lanes takes one point operation. A step's
// independent Fq products run side by side, lane l taking the l-th, and
// pass through the group's exchange words x in shared memory; the
// additions between the steps every lane does alike (SIMT: one stream of
// instructions for all). So a double is two products in a row, not eight,
// and an add two, not twelve. The field values are those of
// g1_double_with / g1_add_with (RCB15, b3 = 12 as an add chain), hence the
// limbs. Every lane of the warp takes the steps (they end in __syncwarp).

__device__ __forceinline__ void fq_load_sh(uint32_t* r, const uint32_t* x) {
#pragma unroll
  for (int j = 0; j < fq::L; j++) r[j] = x[j];
}

// r = one of up to six values by the lane's index, limb by limb (no
// run-time index into a register array).
__device__ __forceinline__ void fq_pick(uint32_t* r, int l, const uint32_t* v0,
                                        const uint32_t* v1,
                                        const uint32_t* v2,
                                        const uint32_t* v3,
                                        const uint32_t* v4,
                                        const uint32_t* v5) {
#pragma unroll
  for (int j = 0; j < fq::L; j++)
    r[j] = l == 0 ? v0[j] : l == 1 ? v1[j] : l == 2 ? v2[j]
         : l == 3 ? v3[j] : l == 4 ? v4[j] : v5[j];
}

// Limbs j = l (mod 8) of r into dst: a group's lanes share a store.
__device__ __forceinline__ void fq_store_part(uint32_t* dst,
                                              const uint32_t* r, int l) {
#pragma unroll
  for (int j = 0; j < fq::L; j++)
    if (j % 8 == l % 8) dst[j] = r[j];
}

// P = 2P in every lane of a group of (at least) 4; x: 4 Fq values.
// Step 1: Y·Y, Y·Z, Z·Z, X·Y; step 2: 12Z²·8Y², YZ·8Y², (Y² − 36Z²)·
// (Y² + 12Z²), (Y² − 36Z²)·XY; then X = 2·w3, Y = w0 + w2, Z = w1.
__device__ __forceinline__ void group_double(G1& P, uint32_t* x, int l) {
  uint32_t a[fq::L], b[fq::L], r[fq::L];
  fq_pick(a, l, P.Y, P.Y, P.Z, P.X, P.X, P.X);
  fq_pick(b, l, P.Y, P.Z, P.Z, P.Y, P.Y, P.Y);
  fq::mul(r, a, b);
  if (l < 4) mont::store<fq::L>(x + fq::L * l, r);
  __syncwarp();
  uint32_t t0[fq::L], z8[fq::L], t2b[fq::L], y3a[fq::L], t0b[fq::L];
  fq_load_sh(t0, x);
  fq_load_sh(t2b, x + 2 * fq::L);
  times_b3<FqInline>(t2b, t2b);                 // 12·Z²
  fq::add(z8, t0, t0);
  fq::add(z8, z8, z8);
  fq::add(z8, z8, z8);                          // 8·Y²
  fq::add(y3a, t0, t2b);
  fq::add(t0b, t2b, t2b);
  fq::add(t0b, t0b, t2b);
  fq::sub(t0b, t0, t0b);                        // Y² − 36·Z²
  uint32_t tyz[fq::L], txy[fq::L];
  fq_load_sh(tyz, x + fq::L);
  fq_load_sh(txy, x + 3 * fq::L);
  fq_pick(a, l, t2b, tyz, t0b, t0b, t0b, t0b);
  fq_pick(b, l, z8, z8, y3a, txy, txy, txy);
  fq::mul(r, a, b);
  __syncwarp();
  if (l < 4) mont::store<fq::L>(x + fq::L * l, r);
  __syncwarp();
  fq_load_sh(a, x);
  fq_load_sh(b, x + 2 * fq::L);
  fq::add(P.Y, a, b);
  fq_load_sh(P.Z, x + fq::L);
  fq_load_sh(a, x + 3 * fq::L);
  fq::add(P.X, a, a);
  __syncwarp();
}

// P = P + Q for points in shared memory (acc = P, in = Q: X[12] Y[12]
// Z[12]), unless `keep`, by a group of (at least) 6 lanes; x: 12 Fq values
// of exchange. Step 1: X1·X2, Y1·Y2, Z1·Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)
// (Y2 + Z2), (X1 + Z1)(X2 + Z2); then every lane makes t3, t4, y3b, t0t,
// z3t, t1t (the names of g1_add_with) and the lanes share their stores;
// step 2: t3·t1t, t4·y3b, y3b·t0t, t1t·z3t, z3t·t4, t0t·t3; then lanes 0..2
// write X = w0 − w1, Y = w2 + w3, Z = w4 + w5 back to acc. A lane holds
// its operands and temporaries only, not the points, so that many groups
// fit an SM (measured against the points in every lane's registers: 192
// registers a thread, faster at 16 keys and slower from 256).
__device__ __forceinline__ void group_add_sh(uint32_t* acc,
                                             const uint32_t* in,
                                             uint32_t* x, int l, bool keep) {
  uint32_t a[fq::L], b[fq::L], c[fq::L], r[fq::L];
  // step 1: X1·X2, Y1·Y2, Z1·Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2),
  // (X1 + Z1)(X2 + Z2): first summand X, Y, Z, X, Y, X; second Y, Z, Z
  const int u = l == 1 || l == 4 ? 1 : l == 2 ? 2 : 0;
  const int v = l == 3 ? 1 : 2;
  fq_load_sh(a, acc + fq::L * u);
  fq_load_sh(c, acc + fq::L * v);
  fq::add(c, a, c);
  fq_pick(a, l, a, a, a, c, c, c);
  fq_load_sh(b, in + fq::L * u);
  fq_load_sh(c, in + fq::L * v);
  fq::add(c, b, c);
  fq_pick(b, l, b, b, b, c, c, c);
  fq::mul(r, a, b);
  if (l < 6) mont::store<fq::L>(x + fq::L * l, r);
  __syncwarp();
  // t3, t4, y3b, t0t, z3t, t1t (the names of g1_add_with) into x[6..11],
  // each lane writing its share of the words
  const uint32_t *t0 = x, *t1 = x + fq::L, *t2 = x + 2 * fq::L;
  uint32_t* y = x + 6 * fq::L;
  fq::add(c, t0, t1);
  fq::sub(r, x + 3 * fq::L, c);
  fq_store_part(y, r, l);                       // t3
  fq::add(c, t1, t2);
  fq::sub(r, x + 4 * fq::L, c);
  fq_store_part(y + fq::L, r, l);               // t4
  fq::add(c, t0, t2);
  fq::sub(r, x + 5 * fq::L, c);
  times_b3<FqInline>(r, r);
  fq_store_part(y + 2 * fq::L, r, l);           // y3b
  fq::add(r, t0, t0);
  fq::add(r, r, t0);
  fq_store_part(y + 3 * fq::L, r, l);           // t0t
  times_b3<FqInline>(c, t2);
  fq::add(r, t1, c);
  fq_store_part(y + 4 * fq::L, r, l);           // z3t
  fq::sub(r, t1, c);
  fq_store_part(y + 5 * fq::L, r, l);           // t1t
  __syncwarp();
  // step 2: t3·t1t, t4·y3b, y3b·t0t, t1t·z3t, z3t·t4, t0t·t3
  const int ia = l == 0 ? 0 : l == 1 ? 1 : l == 2 ? 2 : l == 3 ? 5
               : l == 4 ? 4 : 3;
  const int ib = l == 0 ? 5 : l == 1 ? 2 : l == 2 ? 3 : l == 3 ? 4
               : l == 4 ? 1 : 0;
  fq_load_sh(a, y + fq::L * ia);
  fq_load_sh(b, y + fq::L * ib);
  fq::mul(r, a, b);
  if (l < 6) mont::store<fq::L>(x + fq::L * l, r);
  __syncwarp();
  if (!keep && l < 3) {
    fq_load_sh(a, x + 2 * fq::L * l);
    fq_load_sh(b, x + 2 * fq::L * l + fq::L);
    if (l == 0) fq::sub(r, a, b);                 // X = w0 − w1
    else fq::add(r, a, b);                        // Y = w2 + w3, Z = w4 + w5
    mont::store<fq::L>(acc + fq::L * l, r);
  }
  __syncwarp();
}

// Words q = part (mod PARTS) of P into dst, as X[12] Y[12] Z[12].
template <int PARTS>
__device__ __forceinline__ void g1_store_part(uint32_t* dst, const G1& P,
                                              int part) {
#pragma unroll
  for (int q = 0; q < fq::L; q++)
    if (q % PARTS == part) {
      dst[q] = P.X[q];
      dst[fq::L + q] = P.Y[q];
      dst[2 * fq::L + q] = P.Z[q];
    }
}

// The ladder's group form: a point a group of LADDER_LANES lanes,
// LADDER_GROUPS points a block of one warp. Each group keeps its table
// T[j] = (j + 1)P, its acc for the adds, the add's operand and the
// exchange words of its products in shared memory (GROUP_WORDS, a stride
// that puts the groups of a warp on different banks); acc stays in every
// lane's registers between the adds. The operations are g1.cuh's ladder,
// in its order: the table (even multiples a double, odd ones an add of P),
// then from the top window down B doubles (group_double) and, where the
// digit is not 0, one add (group_add_sh, its result kept where the digit
// is 0). A group past the end runs the last point and stores nothing,
// since every lane of the warp takes the steps.
constexpr int LADDER_LANES = 8;
constexpr int LADDER_GROUPS = 32 / LADDER_LANES;
constexpr int LADDER_MULTIPLES = 1 << (LADDER_DIGIT_BITS - 1);
constexpr int LADDER_ACC = LADDER_MULTIPLES * G1_WORDS;
constexpr int LADDER_IN = LADDER_ACC + G1_WORDS;
constexpr int LADDER_X = LADDER_IN + G1_WORDS;
constexpr int GROUP_WORDS = LADDER_X + 12 * fq::L;
static_assert(GROUP_WORDS % 4 == 0 && GROUP_WORDS % 32 != 0,
              "16-byte aligned, a warp's groups on different banks");

__global__ void __launch_bounds__(32)
g1_scalar_mul_group_kernel(const uint32_t* __restrict__ p,
                           const uint32_t* __restrict__ scalars,
                           uint32_t* __restrict__ out, long long n) {
  constexpr int B = LADDER_DIGIT_BITS, W = ladder_windows<B>;
  __shared__ __align__(16) uint32_t sh[LADDER_GROUPS * GROUP_WORDS];
  const int l = threadIdx.x % LADDER_LANES, g = threadIdx.x / LADDER_LANES;
  const long long i = blockIdx.x * (long long)LADDER_GROUPS + g;
  const bool live = i < n;
  const long long src = live ? i : n - 1;
  const uint32_t* k = scalars + 8 * src;
  uint32_t* T = sh + g * GROUP_WORDS;
  uint32_t *acc_sh = T + LADDER_ACC, *in = T + LADDER_IN, *x = T + LADDER_X;
  G1 acc;
  g1_load(acc, p + G1_WORDS * src);
  g1_store_part<LADDER_LANES>(T, acc, l);
  __syncwarp();
#pragma unroll 1
  for (int m = 2; m <= LADDER_MULTIPLES; m++) {
    uint32_t* e = T + G1_WORDS * (m - 1);
    if (m % 2 == 0) {
      g1_load(acc, T + G1_WORDS * (m / 2 - 1));
      group_double(acc, x, l);
      g1_store_part<LADDER_LANES>(e, acc, l);
    } else {
      for (int q = l; q < G1_WORDS; q += LADDER_LANES) e[q] = e[q - G1_WORDS];
      __syncwarp();
      group_add_sh(e, T, x, l, false);
    }
    __syncwarp();
  }
  const int carry = signed_digit<B>(k, W);
  if (carry) g1_load(acc, T);
  else g1_set_infinity(acc);
#pragma unroll 1
  for (int w = W - 1; w >= 0; w--) {
    if (w < W - 1 || __any_sync(0xffffffffu, carry)) {
#pragma unroll 1
      for (int b = 0; b < B; b++) group_double(acc, x, l);
    }
    const int d = signed_digit<B>(k, w);
    if (__any_sync(0xffffffffu, d != 0)) {
      // in = T[|d| − 1], Y negated where d < 0 (T[0] where d = 0: kept)
      const uint32_t* e = T + G1_WORDS * ((d < 0 ? -d : d > 0 ? d : 1) - 1);
      uint32_t y[fq::L];
      fq_load_sh(y, e + fq::L);
      if (d < 0) {
        uint32_t zero[fq::L] = {};
        fq::sub(y, zero, y);
      }
      fq_store_part(in + fq::L, y, l);
      for (int q = l; q < fq::L; q += LADDER_LANES) {
        in[q] = e[q];
        in[2 * fq::L + q] = e[2 * fq::L + q];
      }
      g1_store_part<LADDER_LANES>(acc_sh, acc, l);
      __syncwarp();
      group_add_sh(acc_sh, in, x, l, d == 0);
      g1_load(acc, acc_sh);
      __syncwarp();
    }
  }
  if (live) g1_store_part<LADDER_LANES>(out + G1_WORDS * i, acc, l);
}

// Launch 1 of the table: key i = TABLE_KEYS·blockIdx.x + group. Its group
// of TABLE_LANES lanes doubles the key FIXED_DIGIT_BITS times a window and
// stores the window's B, 2B, 4B and 8B on the way (entries 0, 1, 3, 7;
// 8B is the next window's B). A group past the end doubles the last key
// and stores nothing, since every lane of the warp takes the steps.
__global__ void __launch_bounds__(32)
g1_fixed_table_kernel(const uint32_t* __restrict__ p,
                      uint32_t* __restrict__ table, long long n) {
  __shared__ __align__(16) uint32_t xs[TABLE_KEYS * TABLE_LANES * fq::L];
  const int l = threadIdx.x % TABLE_LANES, g = threadIdx.x / TABLE_LANES;
  uint32_t* x = xs + g * TABLE_LANES * fq::L;
  const long long i = blockIdx.x * (long long)TABLE_KEYS + g;
  const bool live = i < n;
  G1 P;
  g1_load(P, p + G1_WORDS * (live ? i : n - 1));
  uint32_t* row = table + G1_WORDS * FIXED_WINDOWS * FIXED_MULTIPLES * i;
#pragma unroll 1
  for (int w = 0; w < FIXED_WINDOWS; w++) {
    uint32_t* e = row + G1_WORDS * FIXED_MULTIPLES * w;
    if (live) g1_store_part<TABLE_LANES>(e, P, l);
    // one copy of the double in the loop (four inlined copies, one for
    // each store, measured slower)
#pragma unroll 1
    for (int b = 0; b < FIXED_DIGIT_BITS; b++) {
      if (w == FIXED_WINDOWS - 1 && b == FIXED_DIGIT_BITS - 1) break;
      group_double(P, x, l);
      if (live && b < FIXED_DIGIT_BITS - 1)  // 2B, 4B, 8B: entries 1, 3, 7
        g1_store_part<TABLE_LANES>(e + G1_WORDS * ((2 << b) - 1), P, l);
    }
  }
}

// Launch 2 of the table: the other multiples of each window's base B, a
// thread an entry, each one add of entries launch 1 stored: 3B = 2B + B,
// 5B = 4B + B, 6B = 4B + 2B, 7B = 8B + (−B).
__global__ void __launch_bounds__(ADD_THREADS, ADD_MIN_BLOCKS)
g1_fixed_multiples_kernel(uint32_t* __restrict__ table, long long bases) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= 4 * bases) return;
  const int j = (int)(t % 4);
  uint32_t* e = table + G1_WORDS * FIXED_MULTIPLES * (t / 4);
  // entry m (the multiple m + 1) = entry a + entry b: 3B = 2B + B,
  // 5B = 4B + B, 6B = 4B + 2B, 7B = 8B + (−B) for j = 0..3
  const int a = j == 3 ? 7 : j == 0 ? 1 : 3, b = j == 2 ? 1 : 0;
  const int m = j == 0 ? 2 : j == 1 ? 4 : j + 3;
  G1 P, Q;
  g1_load(P, e + G1_WORDS * a);
  g1_load(Q, e + G1_WORDS * b);
  if (j == 3) {
    uint32_t zero[fq::L] = {};
    fq::sub(Q.Y, zero, Q.Y);
  }
  g1_add(P, P, Q);
  g1_store(e + G1_WORDS * m, P);
}

// Digit w of k (8 canonical little-endian words) in the signed recoding
// with digits in [-7, 8] (g1.cuh:signed_digit).
__device__ __forceinline__ int fixed_digit(const uint32_t* k, int w) {
  return signed_digit<FIXED_DIGIT_BITS>(k, w);
}

// Term j of an MSM with scalars k (m of them): d·[16^w]P_i, i = j / 64,
// w = j % 64, d the signed digit w of k_i: entry [i][w][|d| − 1], negated
// where d < 0; infinity where d = 0 or j ≥ 64·m.
__device__ __forceinline__ void fixed_term(G1& P,
                                           const uint32_t* __restrict__ table,
                                           const uint32_t* __restrict__ k,
                                           long long j, int m) {
  int d = 0;
  const long long i = j / FIXED_WINDOWS;
  const int w = (int)(j % FIXED_WINDOWS);
  if (i < m) d = fixed_digit(k + 8 * i, w);
  if (d == 0) {
    g1_set_infinity(P);
    return;
  }
  g1_load(P, table + G1_WORDS * ((i * FIXED_WINDOWS + w) * FIXED_MULTIPLES
                                 + (d < 0 ? -d : d) - 1));
  if (d < 0) {
    uint32_t zero[fq::L] = {};
    fq::sub(P.Y, zero, P.Y);
  }
}

// The inputs of this block, of the launch's n.
__device__ __forceinline__ int fixed_count(long long n) {
  const long long rest = n - blockIdx.x * (long long)FIXED_FAN_IN;
  return rest < FIXED_FAN_IN ? (int)rest : FIXED_FAN_IN;
}

// The block's halving tree over its `count` inputs (FIXED_FAN_IN but in a
// launch's last block), the points in shared memory: group g holds inputs
// g and g + FIXED_GROUPS. A short block is padded with infinity up to its
// power of two p; then at s = p/2, ..., 1 group g < s adds entry g + s to
// its own (ops/curve.py:tree_sum's tree). A warp with a group that adds
// takes the steps whole; its other groups keep their sums. Group 0 stores
// the block's sum to out.
__device__ __forceinline__ void fixed_block_sum(uint32_t* pts, int count,
                                                uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t xs[FIXED_GROUPS * 12 * fq::L];
  const int g = threadIdx.x / FIXED_LANES, l = threadIdx.x % FIXED_LANES;
  const int first = threadIdx.x / 32 * (32 / FIXED_LANES);
  uint32_t* x = xs + g * 12 * fq::L;
  int p = 1;
  while (p < count) p *= 2;
  for (int q = count * G1_WORDS + threadIdx.x; q < p * G1_WORDS;
       q += FIXED_THREADS) {
    const int word = q % G1_WORDS - fq::L;
    pts[q] = word >= 0 && word < fq::L ? fq::ONE[word] : 0u;
  }
  __syncthreads();
#pragma unroll 1
  for (int s = p / 2; s >= 1; s /= 2) {
    if (first < s)
      group_add_sh(pts + G1_WORDS * g, pts + G1_WORDS * (g + s), x, l,
                   g >= s);
    __syncthreads();
  }
  if (g == 0)
    for (int q = l; q < G1_WORDS; q += FIXED_LANES) out[q] = pts[q];
}

// Launch 1 of the MSM: the terms j = FIXED_FAN_IN·blockIdx.x + input of
// MSM blockIdx.y; partial[blockIdx.y][blockIdx.x] = the block's sum.
__global__ void __launch_bounds__(FIXED_THREADS)
g1_msm_fixed_kernel(const uint32_t* __restrict__ table,
                    const uint32_t* __restrict__ scalars,
                    uint32_t* __restrict__ partial, int m) {
  __shared__ __align__(16) uint32_t pts[FIXED_FAN_IN * G1_WORDS];
  const int g = threadIdx.x / FIXED_LANES, h = threadIdx.x % FIXED_LANES / 4;
  const int input = g + h * FIXED_GROUPS;
  const long long j = blockIdx.x * (long long)FIXED_FAN_IN + input;
  G1 P;
  fixed_term(P, table, scalars + 8 * (long long)blockIdx.y * m, j, m);
  g1_store_part<4>(pts + G1_WORDS * input, P, threadIdx.x % 4);
  fixed_block_sum(pts, fixed_count(FIXED_WINDOWS * (long long)m),
                  partial + G1_WORDS * ((long long)blockIdx.y * gridDim.x +
                                        blockIdx.x));
}

// Every later launch: input j < n of MSM blockIdx.y is src[blockIdx.y][j];
// dst[blockIdx.y][blockIdx.x] = the block's sum.
__global__ void __launch_bounds__(FIXED_THREADS)
g1_msm_fixed_sum_kernel(const uint32_t* __restrict__ src,
                        uint32_t* __restrict__ dst, long long n) {
  __shared__ __align__(16) uint32_t pts[FIXED_FAN_IN * G1_WORDS];
  const long long base = blockIdx.x * (long long)FIXED_FAN_IN;
  const uint32_t* row = src + G1_WORDS * ((long long)blockIdx.y * n + base);
  const long long words = G1_WORDS * (n - base < FIXED_FAN_IN
                                          ? n - base : FIXED_FAN_IN);
  for (int q = threadIdx.x; q < words; q += FIXED_THREADS) pts[q] = row[q];
  fixed_block_sum(pts, fixed_count(n),
                  dst + G1_WORDS * ((long long)blockIdx.y * gridDim.x +
                                    blockIdx.x));
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

// scalars: (n, 8) canonical 32-bit words, little-endian, any 256-bit
// value; grouped: the group form (a point a group of LADDER_LANES lanes),
// else a thread a point. The wrapper picks by n (ops/kernels.py).
extern "C" int zkp_g1_scalar_mul(const void* p, const void* scalars,
                                 void* out, long long n, int grouped,
                                 void* stream) {
  if (n > 0 && grouped) {
    const long long blocks = (n + LADDER_GROUPS - 1) / LADDER_GROUPS;
    g1_scalar_mul_group_kernel<<<(unsigned)blocks, 32, 0,
                                 (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)scalars, (uint32_t*)out, n);
  } else if (n > 0) {
    const long long blocks = (n + LADDER_THREADS - 1) / LADDER_THREADS;
    g1_scalar_mul_kernel<<<(unsigned)blocks, LADDER_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)scalars, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// table: (n, FIXED_WINDOWS, FIXED_MULTIPLES, 3, 12).
extern "C" int zkp_g1_fixed_table(const void* p, void* table, long long n,
                                  void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long blocks = (n + TABLE_KEYS - 1) / TABLE_KEYS;
    g1_fixed_table_kernel<<<(unsigned)blocks, 32, 0,
                            (cudaStream_t)stream>>>(
        (const uint32_t*)p, (uint32_t*)table, n);
    const long long bases = n * FIXED_WINDOWS;
    g1_fixed_multiples_kernel<<<(unsigned)((4 * bases + ADD_THREADS - 1) /
                                           ADD_THREADS),
                                ADD_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)table, bases);
  }
  return (int)cudaGetLastError();
}

// table (m, FIXED_WINDOWS, FIXED_MULTIPLES, 3, 12) from g1_fixed_table;
// scalars (k, m, 8) canonical 32-bit words (< 2^255); scratch (k, n1 + n2,
// 3, 12), n1 = ceil(64·m / 32) and n2 = ceil(n1 / 32); out (k, 3, 12).
// windows, multiples, fan_in: the caller's FIXED_WINDOWS, FIXED_MULTIPLES
// and FIXED_FAN_IN, refused unless they are these.
extern "C" int zkp_g1_msm_fixed(const void* table, const void* scalars,
                                void* scratch, void* out, int k, int m,
                                int windows, int multiples, int fan_in,
                                void* stream) {
  if (windows != FIXED_WINDOWS || multiples != FIXED_MULTIPLES ||
      fan_in != FIXED_FAN_IN || k < 1 || k > 65535 || m < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  long long n = (long long)FIXED_WINDOWS * m;
  long long blocks = (n + FIXED_FAN_IN - 1) / FIXED_FAN_IN;
  uint32_t* a = (uint32_t*)scratch;
  uint32_t* b = a + (long long)G1_WORDS * k * blocks;
  uint32_t* dst = a;
  g1_msm_fixed_kernel<<<dim3((unsigned)blocks, (unsigned)k), FIXED_THREADS,
                        0, st>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, dst, m);
  while (blocks > 1) {
    n = blocks;
    blocks = (n + FIXED_FAN_IN - 1) / FIXED_FAN_IN;
    const uint32_t* src = dst;
    dst = blocks == 1 ? (uint32_t*)out : (src == a ? b : a);
    g1_msm_fixed_sum_kernel<<<dim3((unsigned)blocks, (unsigned)k),
                              FIXED_THREADS, 0, st>>>(src, dst, n);
  }
  return (int)cudaGetLastError();
}
