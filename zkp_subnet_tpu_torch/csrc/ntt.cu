// K5: one radix-2 decimation-in-time butterfly stage of a batched NTT over
// Fr, in place.
//
// Replaces zkp_subnet_tpu/ops/pallas_g1.py:pbutterfly (the fused
// [e + o·w, e − o·w] mod r of every stage of ntt._ntt_base8,
// zkp_subnet_tpu/ops/ntt.py:160-186). On the TPU the even/odd split, the
// twiddle broadcast and the re-interleave of each stage are reshapes and a
// stack around the kernel; here the kernel works out its own offsets from
// the stage number and nothing is materialised.
//
// Data: v is (rows, n, 8) u32 Montgomery values in bit-reversed order before
// stage 1; tw is the (n/2, 8) table [w^0 .. w^(n/2-1)]. Stage s (1-based)
// has half = 2^(s-1): thread (row, k), k < n/2, owns the pair
//   j = (k / half)·2·half + (k mod half),  j + half
// reads e = v[j], o = v[j + half], w = tw[(k mod half)·(n/2)/half] and
// writes e + o·w and e − o·w back. The update is in place and safe because
// no other thread touches either element in this stage.
//
// Bound on the H100: bytes. A stage reads and writes every element once
// (2·32 B per element; 2^16 × 16 rows = 64 MB, ~20 µs at 3.35 TB/s) for one
// Fr product, one add and one subtract per pair (128 wide multiply-adds).
// Each thread moves its two elements as 16-byte words; neighbouring threads
// touch neighbouring elements except inside the first two stages. All
// offsets are 64-bit (2^22 × 32 B = 128 MB per row). One launch per stage:
// keeping several stages in shared memory is later work.
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

__global__ void __launch_bounds__(256)
fr_butterfly_kernel(uint32_t* v, const uint32_t* __restrict__ tw,
                    long long pairs, int log_n, int stage) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const long long half_n = 1LL << (log_n - 1);
  const long long row = i >> (log_n - 1);
  const long long k = i & (half_n - 1);
  const long long half = 1LL << (stage - 1);
  const long long pos = k & (half - 1);
  const long long j = ((k >> (stage - 1)) << stage) + pos;
  const long long stride = half_n >> (stage - 1);
  uint32_t* pe = v + ((row << log_n) + j) * fr::L;
  uint32_t* po = pe + half * fr::L;
  uint32_t e[fr::L], o[fr::L], w[fr::L], t[fr::L], r[fr::L];
  mont::load<fr::L>(e, pe);
  mont::load<fr::L>(o, po);
  mont::load<fr::L>(w, tw + pos * stride * fr::L);
  fr::mul(t, o, w);
  fr::add(r, e, t);
  mont::store<fr::L>(pe, r);
  fr::sub(r, e, t);
  mont::store<fr::L>(po, r);
}

constexpr int THREADS = 256;

}  // namespace

// v: (rows, 2^log_n, 8) in place; tw: (2^(log_n-1), 8); stage in 1..log_n.
extern "C" int zkp_fr_butterfly(void* v, const void* tw, long long rows,
                                int log_n, int stage, void* stream) {
  const long long pairs = rows << (log_n - 1);
  if (pairs > 0) {
    const long long blocks = (pairs + THREADS - 1) / THREADS;
    fr_butterfly_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
        (uint32_t*)v, (const uint32_t*)tw, pairs, log_n, stage);
  }
  return (int)cudaGetLastError();
}
