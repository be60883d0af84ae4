"""The CUDA field and point code (zkp_subnet_tpu_torch/csrc/mont.cuh,
fq.cuh, fr.cuh, g1.cuh) compiled for the host with g++, against Python's
integers and the port's plain point formulas: the field operations (the
squaring mont::sqr among them), the binary inverse (fr::inv), Horner's
steps (fr::horner_step, fr::tree_step: K3 fr_eval_rows's runs and its
tree), the power tables
(fr::power_table, a level by fr::level_scan) and their lookup
(fr::table_pow), the point add and double, and the ladder (g1_scalar_mul
over signed windows, and the recoding signed_digit that both of its
kernel forms run).

The headers' carry chains are PTX (csrc/ptx.cuh), which only the card runs.
Here ptx.cuh is replaced by an emulation of its functions with a carry flag
a thread, which is what the card's CC.CF is to a thread, so that a change
to the chains can be checked without the card. A table is built as a block
of the card builds it: a host thread for each of the block's threads, a
barrier where the block has one. The card tests
(tests/test_torch_cuda.py) hold the kernels themselves to the plain
versions. Skipped where there is no g++. Tolerance: none (integer
arithmetic).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkp_subnet_tpu_torch.ops import curve as tcv
from zkp_subnet_tpu_torch.ops import kernels
from zkp_subnet_tpu_torch.utils import oracle as o

# ptx.cuh's functions on the host: CF is the carry of an add, the borrow
# of a subtract, as on the card
PTX_EMULATION = r"""
#pragma once
#include <cstdint>
namespace ptx {
inline thread_local uint32_t cf = 0;
inline uint32_t set(uint64_t s) { cf = (uint32_t)(s >> 32); return (uint32_t)s; }
inline uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set((uint64_t)(a * b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set((uint64_t)(a * b) + c + cf);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return set((uint64_t)mul_hi(a, b) + c + cf);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return mul_hi(a, b) + c + cf;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) { return set((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return set((uint64_t)a + b + cf);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { cf = a < b; return a - b; }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a - b - cf;
  cf = (uint32_t)(s >> 63);
  return (uint32_t)s;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - cf; }
}  // namespace ptx
"""

# reads records "op word...", writes the result's words a line each:
# ops 0-2 Fr mul/add/sub, 3-5 Fq mul/add/sub, 6 g1_add, 7 g1_double,
# 8 Fr inverse, 9 the ladder (a point, then its scalar's 8 words), 10 a
# Horner run (X, a count m, then m coefficients: Σ c_e·X^e by
# fr::horner_step from the top, below 2r between the steps, then one
# conditional subtract), 14 a tree step (a, b, x^d: a + x^d·b),
# 11 a power table (x, then levels and canonical0; all its
# entries on one line), 12 lookups in one (x, levels, canonical0, a count
# m, then m exponents as two words each, low first; a line each), 13 the
# ladder's signed digits of a scalar's 8 words (4-bit windows and the
# carry, then 5-bit windows and the carry: two lines), 15-16 Fr/Fq squaring
HOST_MAIN = r"""
#include <pthread.h>

#include <cstdint>
#include <cstdio>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
#include "fr.cuh"
#include "g1.cuh"

static void read(uint32_t* w, int n) {
  for (int j = 0; j < n; j++) scanf("%x", &w[j]);
}
static void write(const uint32_t* w, int n) {
  for (int j = 0; j < n; j++) printf("%08x%c", w[j], j + 1 < n ? ' ' : '\n');
}

struct HostSync {
  pthread_barrier_t* bar;
  void operator()() const { pthread_barrier_wait(bar); }
};

struct TableJob {
  uint32_t *T, *S;
  const uint32_t* x;
  int levels, i;
  bool canonical0;
  pthread_barrier_t* bar;
};

static void* table_thread(void* p) {
  const TableJob* j = (const TableJob*)p;
  fr::power_table<fr::POW_LEVEL_BITS>(j->T, j->S, j->x, j->levels,
                                      j->canonical0, j->i, HostSync{j->bar});
  return nullptr;
}

// x's table as a block of POW_WIDTH threads builds it on the card
static void build_table(uint32_t* T, const uint32_t* x, int levels,
                        bool canonical0) {
  constexpr int W = fr::POW_WIDTH;
  static uint32_t S[(2 * W + 1) * fr::L];
  pthread_barrier_t bar;
  pthread_barrier_init(&bar, nullptr, W);
  pthread_t th[W];
  TableJob jobs[W];
  for (int i = 0; i < W; i++) {
    jobs[i] = {T, S, x, levels, i, canonical0, &bar};
    pthread_create(&th[i], nullptr, table_thread, &jobs[i]);
  }
  for (int i = 0; i < W; i++) pthread_join(th[i], nullptr);
  pthread_barrier_destroy(&bar);
}

int main() {
  int op;
  while (scanf("%d", &op) == 1) {
    alignas(16) uint32_t a[36], b[36], r[36];
    if (op == 8) {
      read(a, fr::L);
      fr::inv(r, a);
      write(r, fr::L);
    } else if (op == 10) {
      uint32_t m, c[fr::L];
      read(a, fr::L);
      read(&m, 1);
      read(r, fr::L);
      for (uint32_t e = 1; e < m; e++) {
        read(c, fr::L);
        fr::horner_step(r, a, c);
      }
      mont::reduce_once<fr::L>(r, r, fr::P);
      write(r, fr::L);
    } else if (op == 14) {
      uint32_t xd[fr::L];
      read(a, fr::L);
      read(b, fr::L);
      read(xd, fr::L);
      fr::tree_step(r, a, b, xd);
      write(r, fr::L);
    } else if (op == 11 || op == 12) {
      static uint32_t T[4 * fr::POW_WIDTH * fr::L];
      read(a, fr::L);
      read(b, 2);
      build_table(T, a, (int)b[0], b[1] != 0);
      if (op == 11) {
        write(T, (int)b[0] * fr::POW_WIDTH * fr::L);
      } else {
        uint32_t m, e[2];
        read(&m, 1);
        for (uint32_t k = 0; k < m; k++) {
          read(e, 2);
          fr::table_pow<fr::POW_LEVEL_BITS>(
              r, T, e[0] | (unsigned long long)e[1] << 32, (int)b[0]);
          write(r, fr::L);
        }
      }
    } else if (op == 13) {
      read(a, 8);
      int d4[ladder_windows<4> + 1], d5[ladder_windows<5> + 1];
      for (int w = 0; w <= ladder_windows<4>; w++)
        d4[w] = signed_digit<4>(a, w);
      for (int w = 0; w <= ladder_windows<5>; w++)
        d5[w] = signed_digit<5>(a, w);
      write((const uint32_t*)d4, ladder_windows<4> + 1);
      write((const uint32_t*)d5, ladder_windows<5> + 1);
    } else if (op == 15 || op == 16) {
      const int n = op == 15 ? fr::L : fq::L;
      read(a, n);
      if (op == 15) fr::sqr(r, a);
      else fq::sqr(r, a);
      write(r, n);
    } else if (op < 6) {
      const int n = op < 3 ? fr::L : fq::L;
      read(a, n);
      read(b, n);
      switch (op) {
        case 0: fr::mul(r, a, b); break;
        case 1: fr::add(r, a, b); break;
        case 2: fr::sub(r, a, b); break;
        case 3: fq::mul(r, a, b); break;
        case 4: fq::add(r, a, b); break;
        case 5: fq::sub(r, a, b); break;
      }
      write(r, n);
    } else {
      G1 P, Q, R;
      read(a, G1_WORDS);
      if (op == 7) {  // as g1_double_kernel moves its points
        g1_load16(P, a);
        g1_double(R, P);
        g1_store16(r, R);
      } else {
        g1_load(P, a);
        if (op == 6) {
          read(b, G1_WORDS);
          g1_load(Q, b);
          g1_add(R, P, Q);
        } else {
          read(b, 8);
          g1_scalar_mul(R, P, b);
        }
        g1_store(r, R);
      }
      write(r, G1_WORDS);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("csrc_host")
    for name in ("mont.cuh", "fq.cuh", "fr.cuh", "g1.cuh"):
        shutil.copy(os.path.join(kernels.CSRC, name), d / name)
    (d / "ptx.cuh").write_text(PTX_EMULATION)
    (d / "main.cpp").write_text(HOST_MAIN)
    exe = d / "fields"
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-pthread", "-o",
                    str(exe), str(d / "main.cpp")], check=True)
    return str(exe)


def _run(exe, records):
    """records: (op, [word arrays]) → one uint32 array per record."""
    text = "\n".join(f"{op} " + " ".join(f"{int(w):x}" for a in arrays
                                          for w in a)
                     for op, arrays in records)
    out = subprocess.run([exe], input=text, capture_output=True, text=True,
                         check=True).stdout
    return [np.array([int(w, 16) for w in line.split()], np.uint32)
            for line in out.splitlines()]


def _words(x: int, n: int):
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(n)]


def _int(words) -> int:
    return sum(int(w) << (32 * j) for j, w in enumerate(words))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_carry_chains_match_python_integers(host_binary, name):
    """mont::mul/add/sub for Fr (8 limbs) and Fq (12) on edge values and
    random ones, against a·b·2^(−32N), a + b and a − b mod p."""
    p, n, base = (o.R, 8, 0) if name == "fr" else (o.Q, 12, 3)
    rng = np.random.default_rng(7)
    vals = [0, 1, 2, p - 1, p - 2, (1 << (32 * (n - 1))) - 1, p >> 1] + [
        int.from_bytes(rng.bytes(4 * n + 8), "little") % p
        for _ in range(60)]
    pairs = [(x, y) for x in vals[:7] for y in vals[:7]] + list(
        zip(vals[7:], vals[::-1][:60]))
    r_inv = pow(1 << (32 * n), -1, p)
    refs = (lambda x, y: x * y * r_inv, lambda x, y: x + y,
            lambda x, y: x - y)
    records = [(base + k, (_words(x, n), _words(y, n)))
               for x, y in pairs for k in range(3)]
    got = _run(host_binary, records)
    want = [refs[k](x, y) % p for x, y in pairs for k in range(3)]
    assert [_int(g) for g in got] == want


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_square_matches_python_integers(host_binary, name):
    """mont::sqr for Fr (8 limbs) and Fq (12) on the chain test's edge
    values (0, 1, 2, p − 1, p − 2, 2^(32(N−1)) − 1, p >> 1) and 60 random
    ones, against a²·2^(−32N) mod p: the fully reduced value mul(a, a)
    gives."""
    p, n, op = (o.R, 8, 15) if name == "fr" else (o.Q, 12, 16)
    rng = np.random.default_rng(37)
    vals = [0, 1, 2, p - 1, p - 2, (1 << (32 * (n - 1))) - 1, p >> 1] + [
        int.from_bytes(rng.bytes(4 * n + 8), "little") % p
        for _ in range(60)]
    got = _run(host_binary, [(op, (_words(x, n),)) for x in vals])
    r_inv = pow(1 << (32 * n), -1, p)
    assert [_int(g) for g in got] == [x * x * r_inv % p for x in vals]


def test_point_formulas_match_plain(host_binary):
    """g1_add / g1_double of g1.cuh (b3 = 12 as an add chain; the double's
    Y² and Z² by fq::sqr) against the plain RCB15 formulas, limb for limb,
    on general projective points, infinity, P + P and P + (−P)."""
    rng = np.random.default_rng(11)
    dlogs = [int.from_bytes(rng.bytes(40), "little") % (o.R - 1) + 1
             for _ in range(6)]
    G = o.G1.from_affine(o.G1_GEN)
    p = tcv.g1_double(tcv.g1_encode([o.G1.mul(G, d) for d in dlogs]))
    inf = tcv.g1_infinity((1,))
    lhs = torch.cat([p, inf, p[:1], p[:1], inf])
    rhs = torch.cat([p.roll(1, 0), p[:1], p[:1], tcv.g1_neg(p[:1]), inf])
    words = lambda t: t.numpy().view(np.uint32).reshape(-1, 36)  # noqa: E731
    records = [(6, (a, b)) for a, b in zip(words(lhs), words(rhs))]
    records += [(7, (a,)) for a in words(lhs)]
    got = np.stack(_run(host_binary, records)).view(np.int32)
    want = torch.cat([tcv.g1_add_plain(lhs, rhs), tcv.g1_double_plain(lhs)])
    assert np.array_equal(got.reshape(-1, 3, 12), want.numpy())


def test_inverse_chain_matches_python_integers(host_binary):
    """fr::inv (K3 fr_inv: Kaliski's binary inverse, then the products by
    2^j and 2^514) on 0, 1, r − 1, r − 2, small values, powers of two (in
    Montgomery form: inputs whose runs of trailing zeros cross whole words,
    and the one that makes j = 255), their Montgomery forms, and random
    values, against x^(r−2) mod r, limb for limb in Montgomery form."""
    rng = np.random.default_rng(13)
    r_inv = pow(1 << 256, -1, o.R)
    edges = [0, 1, 2, 3, o.R - 1, o.R - 2, (o.R - 1) // 2] + [
        1 << e for e in (31, 32, 64, 200, 254)]
    vals = edges + [e * r_inv % o.R for e in edges] + [
        int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(200)]
    mont = [v * (1 << 256) % o.R for v in vals]
    got = _run(host_binary, [(8, (_words(m, 8),)) for m in mont])
    assert [_int(g) for g in got] == [pow(v, o.R - 2, o.R) * (1 << 256)
                                      % o.R for v in vals]


MONT = 1 << 256

#: Fr values the Horner helpers are held to: 0, 1, r − 1, r − 2 and random
HORNER_VALUES = [0, 1, o.R - 1, o.R - 2] + [
    int.from_bytes(np.random.default_rng(29).bytes(40), "little") % o.R
    for _ in range(4)]


@pytest.mark.parametrize("m", [1, 2, 8, 33])
def test_horner_run_matches_python_integers(host_binary, m):
    """fr::horner_step (a lane's run in K3 fr_eval_rows, and a lane's run
    over the tiles in its second pass) from h = c_(m-1) down to c_0 with X
    0, 1, r − 1, r − 2 and random (in Montgomery form, as x^32 and x^(32
    tile) are), on coefficients that hold each of those values and a row
    of zeros, h kept below 2r between the steps and reduced once at the
    end: Σ c_e·X^e mod r, limb for limb in Montgomery form."""
    rng = np.random.default_rng(31 + m)
    rows = [[int.from_bytes(rng.bytes(40), "little") % o.R
             for _ in range(m)] for _ in range(3)]
    rows[0][:4] = HORNER_VALUES[:min(4, m)]
    rows.append([0] * m)
    cases = [(X, row) for X in HORNER_VALUES[:5] for row in rows]
    got = _run(host_binary, [
        (10, (_words(X * MONT % o.R, 8), [m],
              *[_words(c * MONT % o.R, 8) for c in row[::-1]]))
        for X, row in cases])
    assert [_int(g) for g in got] == [
        sum(c * pow(X, e, o.R) for e, c in enumerate(row)) * MONT % o.R
        for X, row in cases]


def test_tree_step_matches_python_integers(host_binary):
    """fr::tree_step (the tree that joins a tile's warps in K3
    fr_eval_rows: a + x^d·b) over every pair of 0, 1, r − 1, r − 2 and
    random values for a and b, at x^d of each: limb for limb in
    Montgomery form."""
    cases = [(a, b, xd) for a in HORNER_VALUES for b in HORNER_VALUES
             for xd in HORNER_VALUES[::2]]
    got = _run(host_binary, [
        (14, tuple(_words(v * MONT % o.R, 8) for v in case))
        for case in cases])
    assert [_int(g) for g in got] == [(a + xd * b) * MONT % o.R
                                      for a, b, xd in cases]


TABLE_XS = [0, 1, o.R - 1, 0x5EED * (1 << 190) + 12345]


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_power_table_matches_python_integers(host_binary, levels):
    """fr::power_table (K3 fr_power_tables: each level a Hillis-Steele
    product scan by fr::level_scan over a block of 256 threads, the next
    level's base from the last entry) at x 0, 1, r − 1 and random: entry i
    of level l is x^(i·256^l), in Montgomery form, or canonical in level 0
    where the table is 1/x's (canonical0)."""
    width = kernels.POW_WIDTH
    cases = [(x, c) for x in TABLE_XS for c in (0, 1)]
    got = _run(host_binary, [(11, (_words(x * MONT % o.R, 8), [levels, c]))
                             for x, c in cases])
    for g, (x, c) in zip(got, cases):
        ints = [_int(g[8 * k:8 * k + 8]) for k in range(levels * width)]
        want = [pow(x, i * width ** lv, o.R)
                * (1 if c and lv == 0 else MONT) % o.R
                for lv in range(levels) for i in range(width)]
        assert ints == want, (x, c)


@pytest.mark.parametrize("levels", [1, 2, 4])
def test_table_lookup_matches_python_integers(host_binary, levels):
    """fr::table_pow (a power in K3 fr_powers and fr_open_quotient: the
    entry of the exponent's lowest digit times one entry a level above) at
    x 0, 1, r − 1 and random, at exponents 0, 1, a level's edges, the top of
    the table's reach and random ones below it, Montgomery and with a
    canonical level 0: x^e mod r."""
    rng = np.random.default_rng(23)
    reach = kernels.POW_WIDTH ** levels
    es = sorted({0, 1, 255, min(256, reach - 1), reach - 1,
                 *(int(v) for v in rng.integers(0, reach, 6))})
    cases = [(x, c) for x in TABLE_XS for c in (0, 1)]
    records = [(12, (_words(x * MONT % o.R, 8), [levels, c, len(es)],
                     [w for e in es for w in _words(e, 2)]))
               for x, c in cases]
    got = iter(_run(host_binary, records))
    for x, c in cases:
        for e in es:
            assert _int(next(got)) == pow(x, e, o.R) * (
                1 if c else MONT) % o.R, (x, c, e)


#: scalars the ladder is held to: 0, 1, r − 1, r − 2; every 4-bit window 8
#: (no carry anywhere); a carry through all 64 windows and out of the top
#: (0x88…89); 2^255 and 2^256 − 1 (a carry out of the top); random
EIGHTS = int("8" * 64, 16)
LADDER_SCALARS = [0, 1, o.R - 1, o.R - 2, EIGHTS, EIGHTS + 1, 1 << 255,
                  (1 << 256) - 1]


def _signed(words):
    return [int(w) - (1 << 32) if w >> 31 else int(w) for w in words]


def test_ladder_digits_match_python_integers(host_binary):
    """signed_digit of g1.cuh (each digit alone, from a comparison of the
    words below its window) at 4 and 5 bits, against the recoding by a
    running carry on Python's integers and against curve.signed_digits:
    digits in [1 − 2^(B−1), 2^(B−1)], Σ d_w·2^(B·w) + carry·2^(B·W) = k."""
    rng = np.random.default_rng(19)
    ks = LADDER_SCALARS + [int.from_bytes(rng.bytes(32), "little")
                           for _ in range(20)]
    got = _run(host_binary, [(13, (_words(k, 8),)) for k in ks])
    for i, k in enumerate(ks):
        for bits, line in ((4, got[2 * i]), (5, got[2 * i + 1])):
            windows = -(-256 // bits)
            digits, carry = [], 0
            for w in range(windows):
                d = (k >> (bits * w) & ((1 << bits) - 1)) + carry
                carry = int(d > 1 << (bits - 1))
                digits.append(d - (carry << bits))
            assert _signed(line) == digits + [carry], (k, bits)
            assert sum(d << (bits * w) for w, d in enumerate(digits)) \
                + (carry << (bits * windows)) == k
            limbs = torch.tensor(_signed(_words(k, 8)), dtype=torch.int32)
            assert tcv.signed_digits(limbs, bits).tolist() == \
                digits + [carry], (k, bits)


def test_ladder_matches_plain_and_python_integers(host_binary):
    """g1_scalar_mul of g1.cuh (the thread form of K1 g1_scalar_mul: signed
    4-bit windows, the table P … 8P) with scalars 0, 1, r − 1, r − 2, every
    window 8, a carry through every window, 2^255, 2^256 − 1 and a random
    one, on projective points and infinity: limb for limb the plain
    ladder's, and [k]P as Python's integers say."""
    rng = np.random.default_rng(17)
    ks = LADDER_SCALARS + [int.from_bytes(rng.bytes(40), "little") % o.R]
    dlogs = [int.from_bytes(rng.bytes(40), "little") % (o.R - 1) + 1
             for _ in range(len(ks) - 1)]
    G = o.G1.from_affine(o.G1_GEN)
    p = tcv.g1_double(tcv.g1_encode([o.G1.mul(G, d) for d in dlogs]))
    p = torch.cat([p, tcv.g1_infinity((1,))])
    sc = torch.tensor([_signed(_words(k, 8)) for k in ks], dtype=torch.int32)
    words = p.numpy().view(np.uint32).reshape(-1, 36)
    got = np.stack(_run(host_binary, [
        (9, (w, _words(k, 8))) for w, k in zip(words, ks)])).view(np.int32)
    assert np.array_equal(got.reshape(-1, 3, 12),
                          tcv.g1_scalar_mul_plain(p, sc).numpy())
    want = [o.G1.to_affine(o.G1.mul(G, 2 * d * k % o.R))
            for d, k in zip(dlogs, ks)] + [None]
    assert tcv.g1_affine(torch.from_numpy(got.reshape(-1, 3, 12))) == want
