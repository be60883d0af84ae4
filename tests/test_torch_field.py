"""The port's field arithmetic (zkp_subnet_tpu_torch/ops/field.py) against
the JAX package's FR/FQ and the bigint oracle, bit for bit.

Inputs come from a numpy seed and cross as numpy arrays; the comparison is
made on the JAX boundary format ((..., L) uint32 16-bit limbs, Montgomery)
and on decoded integers. Tolerance: none (integer arithmetic).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp_subnet_tpu.ops.field import FQ as JFQ
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.ops import field as tf
from zkp_subnet_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = {"fr": (tf.FR, JFR), "fq": (tf.FQ, JFQ)}


def _values(p: int, seed: int, n: int = 48):
    """n ints < p from a numpy seed, the first four being 0, 1, p−1, p−2."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % p for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_ops_match_jax_and_oracle(name):
    TF, JF = FIELDS[name]
    xs = _values(TF.p, 1)
    ys = _values(TF.p, 2)[::-1]
    ja, jb = JF.encode(xs), JF.encode(ys)
    a = TF.from_limbs16(np.asarray(ja))
    b = TF.from_limbs16(np.asarray(jb))
    assert TF.decode(a) == xs
    cases = [("mont_mul", JF.mont_mul, lambda x, y: x * y),
             ("add", JF.add, lambda x, y: x + y),
             ("sub", JF.sub, lambda x, y: x - y)]
    for op, jop, ref in cases:
        got = getattr(TF, op)(a, b)
        assert np.array_equal(TF.to_limbs16(got), np.asarray(jop(ja, jb))), op
        assert TF.decode(got) == [ref(x, y) % TF.p for x, y in zip(xs, ys)]
    assert TF.decode(TF.neg(a)) == [-x % TF.p for x in xs]
    assert np.array_equal(TF.to_limbs16(TF.neg(a)), np.asarray(JF.neg(ja)))
    assert np.array_equal(TF.to_limbs16(TF.sqr(a)), np.asarray(JF.sqr(ja)))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_pow_static_and_inv_match_jax_and_oracle(name):
    """Fermat inversion incl. 0 ↦ 0, and a^e for a static exponent."""
    TF, JF = FIELDS[name]
    xs = _values(TF.p, 6, n=6)
    ja = JF.encode(xs)
    a = TF.from_limbs16(np.asarray(ja))
    got = TF.inv(a)
    assert np.array_equal(TF.to_limbs16(got), np.asarray(JF.inv(ja)))
    assert TF.decode(got) == [pow(x, TF.p - 2, TF.p) for x in xs]
    assert TF.decode(got)[0] == 0
    for e in (0, 1, 4, 0b1011001):
        assert TF.decode(TF.pow_static(a, e)) == [pow(x, e, TF.p) for x in xs]
    one = TF.pow_static(a[5], 0)
    assert one.shape == (TF.L,) and TF.decode(one) == [1]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_to_from_mont_match_jax(name):
    TF, JF = FIELDS[name]
    xs = _values(TF.p, 3)
    canon = np.stack([JF.to_limbs(x) for x in xs])
    mont = TF.to_mont(TF.from_limbs16(canon))
    assert np.array_equal(TF.to_limbs16(mont),
                          np.asarray(JF.to_mont(jnp.asarray(canon))))
    back = TF.from_mont(mont)
    assert np.array_equal(TF.to_limbs16(back),
                          np.asarray(JF.from_mont(JF.to_mont(
                              jnp.asarray(canon)))))
    assert TF.limbs_to_ints(back) == xs


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_plain_ops_broadcast_a_single_operand(name):
    TF, _ = FIELDS[name]
    xs = _values(TF.p, 4, n=16)
    a = TF.encode(xs)
    c = TF.encode([xs[7]])
    assert TF.decode(TF.mont_mul(a, c)) == [x * xs[7] % TF.p for x in xs]
    assert TF.decode(TF.add(c, a)) == [(x + xs[7]) % TF.p for x in xs]


def test_fr_inv_plain_matches_jax_and_oracle():
    """The plain version of K3 fr_inv (the kernel's binary inverse)
    against the JAX package's inverse, limb for limb, 0 ↦ 0 included."""
    xs = _values(tf.FR.p, 6, n=6)                  # JFR.inv's shape above
    ja = JFR.encode(xs)
    got = tf.fr_inv_plain(tf.FR.from_limbs16(np.asarray(ja)))
    assert np.array_equal(tf.FR.to_limbs16(got), np.asarray(JFR.inv(ja)))
    assert tf.FR.decode(got) == [pow(x, o.R - 2, o.R) for x in xs]


def test_fr_inv_plain_edges_and_itsalmost_inverse():
    """fr_inv_plain on 0, 1, r − 1, r − 2, powers of two, their Montgomery
    forms (Montgomery 1 is the input that makes j = 255) and random values
    against x^(r−2), in a batch of any shape; and Kaliski's almost inverse
    under it: x = a^(−1)·2^k with 255 ≤ k ≤ 510, the bound the kernel's
    two closing products rely on."""
    r_inv = pow(1 << 256, -1, o.R)
    edges = [0, 1, 2, o.R - 1, o.R - 2, 1 << 32, 1 << 254]
    xs = edges + [e * r_inv % o.R for e in edges] + _values(o.R, 9, n=11)
    a = tf.FR.encode(xs).view(5, 5, 8)
    got = tf.fr_inv_plain(a)
    assert got.shape == a.shape
    assert tf.FR.decode(got) == [pow(x, o.R - 2, o.R) for x in xs]
    for x in tf.FR.limbs_to_ints(a):
        if x:
            y, k, steps = tf.almost_inverse(x)
            assert 255 <= k <= 510 and y == pow(x, -1, o.R) * 2**k % o.R
            assert 1 <= steps <= k


def test_fr_powers_plain_matches_jax_and_oracle():
    """The plain versions of K3 fr_power_tables and fr_powers (x^k looked
    up in the table of x: level l holds x^(i·width^l), one entry a level)
    against the JAX package's powers, with and without the termwise factor
    c, one row and three, at x random, 0, 1 and r − 1, a width that is no
    power of two, and level widths of 2 and 4 (five and three levels) and
    the kernel's 256 (one)."""
    n = 21
    cs = _values(tf.FR.p, 8, n=n)
    jc = JFR.encode(cs)
    c = tf.FR.from_limbs16(np.asarray(jc))
    for x in (_values(tf.FR.p, 7, n=5)[4], 0, 1, o.R - 1):
        jx = JFR.encode([x])[0]
        jpw = JFR.powers(jx, n)
        xt = tf.FR.encode([x])[0]
        for width in (2, 4):
            table = tf.fr_power_tables_plain(xt, n, width=width)
            assert table.shape == (1, kernels.power_levels(n, width), width,
                                   8)
            got = tf.fr_powers_plain(table[0], n)
            assert np.array_equal(tf.FR.to_limbs16(got), np.asarray(jpw)), x
        table = tf.fr_power_tables_plain(xt, n)[0]
        got = tf.fr_powers_plain(table, n)
        assert np.array_equal(tf.FR.to_limbs16(got), np.asarray(jpw)), x
        assert tf.FR.decode(got) == [pow(x, k, o.R) for k in range(n)]
        got = tf.fr_powers_plain(table, n, c)
        assert np.array_equal(tf.FR.to_limbs16(got),
                              np.asarray(JFR.mont_mul(jc, jpw))), x
        assert torch.equal(got, tf.FR.mont_mul(c, tf.FR.powers(xt, n)))
        rows = torch.stack([c, c.flip(0), c.roll(3, 0)])
        got = tf.fr_powers_plain(table, n, rows)
        assert torch.equal(got, tf.FR.mont_mul(rows, tf.FR.powers(xt, n)))
    five = tf.FR.encode([5])[0]
    assert tf.FR.decode(tf.fr_powers_plain(
        tf.fr_power_tables_plain(five, 1)[0], 1)) == [1]


def test_power_tables_plain_of_the_inverse_are_canonical_at_level_0():
    """fr_power_tables_plain of x and 1/x at level widths 4 and 256: table
    0 holds x^(i·width^l) in Montgomery form; table 1 holds (1/x)^(i·width^l),
    its level 0 out of Montgomery form (the quotient's product by the
    integer 1 folded in), the levels above in it; levels as n needs."""
    x = _values(tf.FR.p, 9, n=5)[4]
    xt = tf.FR.encode([x])[0]
    xi = pow(x, o.R - 2, o.R)
    for n, width in ((300, 4), (300, 256), (1 << 16, 256), ((1 << 16) + 1,
                                                             256)):
        levels = kernels.power_levels(n, width)
        assert width ** levels >= n > width ** (levels - 1) or levels == 1
        t = tf.fr_power_tables_plain(xt, n, tf.FR.inv(xt), width)
        assert t.shape == (2, levels, width, 8)
        for lv in range(levels):
            want = [pow(x, i * width ** lv, o.R) for i in range(width)]
            assert tf.FR.decode(t[0, lv]) == want
            want = [pow(xi, i * width ** lv, o.R) for i in range(width)]
            got = (tf.FR.limbs_to_ints(t[1, lv]) if lv == 0
                   else tf.FR.decode(t[1, lv]))
            assert got == want, (n, width, lv)


def test_powers_select_is_zero():
    x = 0x1234567890ABCDEF
    pw = tf.FR.powers(tf.FR.encode([x])[0], 21)
    assert tf.FR.decode(pw) == [pow(x, j, o.R) for j in range(21)]
    a, b = tf.FR.encode([1, 2, 3]), tf.FR.encode([4, 5, 6])
    cond = torch.tensor([True, False, True])
    assert tf.FR.decode(tf.FR.select(cond, a, b)) == [1, 5, 3]
    assert tf.FR.is_zero(tf.FR.encode([0, 1, 0])).tolist() == [True, False,
                                                               True]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_repack_16_32_roundtrip(name):
    """16-bit (JAX) ↔ 32-bit (port) limbs, bit for bit, both ways —
    including words with the sign bit set."""
    TF, _ = FIELDS[name]
    rng = np.random.default_rng(5)
    l16 = rng.integers(0, 1 << 16, (7, 3, TF.L16), dtype=np.uint32)
    l16[0, 0, :] = 0xFFFF
    t = TF.from_limbs16(l16)
    assert t.dtype == torch.int32 and t.shape == (7, 3, TF.L)
    assert np.array_equal(TF.to_limbs16(t), l16)
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (5, TF.L),
                                          dtype=np.int64).astype(np.int32))
    assert torch.equal(TF.from_limbs16(TF.to_limbs16(words)), words)
    assert torch.equal(tf.narrow(tf.widen(words)), words)
    with pytest.raises(ValueError):
        TF.from_limbs16(np.full((1, TF.L16), 1 << 16, np.uint32))


def _source(header: str) -> str:
    with open(os.path.join(kernels.CSRC, header)) as f:
        return f.read()


def _cuda_array(header: str, name: str):
    body = re.search(rf"{name}\[L\] = \{{(.*?)\}};", _source(header),
                     re.S).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    return sum(w << (32 * k) for k, w in enumerate(words))


def _cuda_scalar(header: str, name: str):
    return int(re.search(rf"{name} = (0x[0-9a-f]+)u;",
                         _source(header)).group(1), 16)


def _cuda_scalar_int(header: str, name: str) -> int:
    return int(re.search(rf"{name} = (\d+);", _source(header)).group(1))


def test_kernel_constants_match_the_fields():
    """The constants written into csrc/fq.cuh and csrc/fr.cuh."""
    R = 1 << 384
    assert _cuda_array("fq.cuh", "P") == o.Q
    assert _cuda_array("fq.cuh", "ONE") == R % o.Q
    assert _cuda_scalar("fq.cuh", "INV") == (-pow(o.Q, -1, 1 << 32)) % (1 << 32)
    assert _cuda_array("fr.cuh", "P") == o.R
    assert _cuda_scalar("fr.cuh", "INV") == (-pow(o.R, -1, 1 << 32)) % (1 << 32)
    # fr::inv's last product, and the top j with 2^j < r
    assert _cuda_array("fr.cuh", "INV_FIX") == pow(2, 514, o.R)
    top = _cuda_scalar_int("fr.cuh", "INV_TOP_BIT")
    assert 1 << top < o.R < 1 << (top + 1)
    # the power tables' level width and their levels at most, as the
    # wrappers hand them over
    assert 1 << _cuda_scalar_int("fr.cuh", "POW_LEVEL_BITS") == \
        kernels.POW_WIDTH
    assert _cuda_scalar_int("fr.cu", "MAX_POW_LEVELS") == \
        kernels.MAX_POW_LEVELS
    # the fixed-base MSM's digits and fan-in, as its wrapper and plain
    # versions take them, and groups of lanes as wide as a step's products
    # (an add's 6, a double's 4)
    assert _cuda_scalar_int("g1.cu", "FIXED_DIGIT_BITS") == \
        kernels.FIXED_DIGIT_BITS
    assert 2 * _cuda_scalar_int("g1.cu", "FIXED_GROUPS") == \
        kernels.FIXED_FAN_IN
    assert _cuda_scalar_int("g1.cu", "FIXED_LANES") >= 6
    assert _cuda_scalar_int("g1.cu", "TABLE_LANES") >= 4


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside a wrapper: a tensor off the card is an error, and
    every public field op has a kernel to go to on the card."""
    a = tf.FR.encode([1, 2])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_mul(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.g1_add(torch.zeros((1, 3, 12), dtype=torch.int32),
                       torch.zeros((1, 3, 12), dtype=torch.int32))
    b = tf.FQ.encode([1, 2])
    for kern, x in ((kernels.fr_sub, a), (kernels.fq_mul, b),
                    (kernels.fq_add, b), (kernels.fq_sub, b)):
        with pytest.raises(ValueError, match="CUDA"):
            kern(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fr_butterfly(a, a[:1], 1)
    table = torch.zeros((1, kernels.POW_WIDTH, 8), dtype=torch.int32)
    for call in (lambda: kernels.fr_inv(a),
                 lambda: kernels.fr_power_tables(a[0], 4, a[1]),
                 lambda: kernels.fr_powers(table, 4),
                 lambda: kernels.fr_suffix_scan(a),
                 lambda: kernels.fr_open_quotient(a, a[:1], a[0], table, a),
                 lambda: kernels.fr_eval_rows(a[None], a[:1]),
                 lambda: kernels.g1_scalar_mul(
                     torch.zeros((2, 3, 12), dtype=torch.int32), a),
                 lambda: kernels.g1_fixed_table(
                     torch.zeros((2, 3, 12), dtype=torch.int32)),
                 lambda: kernels.g1_msm_fixed(
                     torch.zeros((2, 64, 8, 3, 12), dtype=torch.int32),
                     a[None])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (tf.FR._mul_kernel, tf.FR._add_kernel, tf.FR._sub_kernel,
            tf.FR._inv_kernel, tf.FR._powers_kernel) == \
        (kernels.fr_mul, kernels.fr_add, kernels.fr_sub, kernels.fr_inv,
         tf.fr_powers_on_card)
    assert (tf.FQ._mul_kernel, tf.FQ._add_kernel, tf.FQ._sub_kernel) == \
        (kernels.fq_mul, kernels.fq_add, kernels.fq_sub)
    assert sorted(kernels.LAUNCHES) == sorted(
        ["g1_add", "g1_double", "g1_scalar_mul", "g1_fixed_table",
         "g1_msm_fixed", "msm_buckets",
         "msm_reduce", "msm_combine", "fr_mul", "fr_add", "fr_sub",
         "fr_inv", "fr_power_tables", "fr_powers", "fr_suffix_scan",
         "fr_open_quotient",
         "fr_eval_rows", "fq_mul", "fq_add", "fq_sub", "fr_butterfly"])


def test_ptxas_usage_keys_each_template_instantiation():
    """nvcc's -Xptxas -v report: a kernel under its plain name, a template
    kernel once for each instantiation (fr_binary_kernel<Op>), and the
    spills of the kernel the registers belong to."""
    ns = "_ZN37_GLOBAL__N__72530e89_5_fr_cu_3d88d23f"
    log = "".join(
        f"ptxas info    : Compiling entry function '{m}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {m}\n"
        f"    {stack} bytes stack frame, {spill} bytes spill stores, "
        f"{spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 0 barriers\n"
        for m, regs, stack, spill in (
            (ns + "16fr_binary_kernelILNS_2OpE0EEEvPKjS3_Pjxii", 46, 0, 0),
            (ns + "16fr_binary_kernelILNS_2OpE2EEEvPKjS3_Pjxii", 26, 0, 0),
            (ns + "13g1_add_kernelEPKjS1_Pjx", 128, 120, 12),
            ("_Z10tpl_kernelILin3EEvv", 8, 0, 0)))
    usage = kernels.ptxas_usage(log)
    assert sorted(usage) == ["fr_binary_kernel<0>", "fr_binary_kernel<2>",
                             "g1_add_kernel", "tpl_kernel<-3>"]
    assert usage["fr_binary_kernel<0>"]["registers"] == 46
    assert usage["fr_binary_kernel<2>"]["registers"] == 26
    assert usage["g1_add_kernel"] == {"registers": 128, "stack": 120,
                                      "spill_stores": 12, "spill_loads": 12}
