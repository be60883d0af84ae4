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


def test_kernel_constants_match_the_fields():
    """The constants written into csrc/fq.cuh and csrc/fr.cuh."""
    R = 1 << 384
    assert _cuda_array("fq.cuh", "P") == o.Q
    assert _cuda_array("fq.cuh", "ONE") == R % o.Q
    assert _cuda_array("fq.cuh", "B3") == 12 * R % o.Q
    assert _cuda_scalar("fq.cuh", "INV") == (-pow(o.Q, -1, 1 << 32)) % (1 << 32)
    assert _cuda_array("fr.cuh", "P") == o.R
    assert _cuda_scalar("fr.cuh", "INV") == (-pow(o.R, -1, 1 << 32)) % (1 << 32)


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
    assert (tf.FR._mul_kernel, tf.FR._add_kernel, tf.FR._sub_kernel) == \
        (kernels.fr_mul, kernels.fr_add, kernels.fr_sub)
    assert (tf.FQ._mul_kernel, tf.FQ._add_kernel, tf.FQ._sub_kernel) == \
        (kernels.fq_mul, kernels.fq_add, kernels.fq_sub)
    assert sorted(kernels.LAUNCHES) == sorted(
        ["g1_add", "g1_double", "msm_buckets", "msm_reduce", "msm_combine",
         "fr_mul", "fr_add", "fr_sub", "fq_mul", "fq_add", "fq_sub",
         "fr_butterfly"])
