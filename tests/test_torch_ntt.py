"""The port's NTT (zkp_subnet_tpu_torch/ops/ntt.py) against the JAX package's
``ops/ntt.py`` and the bigint oracle.

Inputs come from a numpy seed and cross as numpy arrays in the JAX boundary
format ((..., N, 16) uint32 16-bit limbs, Montgomery). A transform has one
result, so whole outputs are compared limb for limb. Tolerance: none
(integer arithmetic). The JAX functions run as the JAX package's own tests
run them on the CPU (the XLA-graph byte engine; no Pallas kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkp_subnet_tpu.ops import lane8 as l8
from zkp_subnet_tpu.ops import ntt as jntt
from zkp_subnet_tpu.ops.field import FR as JFR
from zkp_subnet_tpu.utils import oracle as o
from zkp_subnet_tpu_torch.ops import ntt as tntt
from zkp_subnet_tpu_torch.ops.field import FR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch: the limb tensors are small, and idle intra-op
    threads would spin against JAX's compiler threads on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(seed, n):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(n)]
    vals[:3] = [0, 1, o.R - 1][:n]
    return vals


@pytest.mark.parametrize("log_n", [1, 3, 4, 5, 6])
def test_ntt_intt_match_jax_and_oracle(log_n):
    n = 1 << log_n
    vals = _values(log_n, n)
    jx = JFR.encode_vec(vals)
    x = FR.from_limbs16(np.asarray(jx))
    fwd = tntt.ntt(x)
    assert np.array_equal(FR.to_limbs16(fwd), np.asarray(jntt.ntt(jx)))
    assert FR.decode(fwd) == o.ntt(vals)
    inv = tntt.intt(x)
    assert np.array_equal(FR.to_limbs16(inv), np.asarray(jntt.intt(jx)))
    assert FR.decode(inv) == o.intt(vals)
    assert torch.equal(tntt.intt(fwd), x)
    assert torch.equal(tntt.ntt(x, inverse=True), inv)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batch_matches_jax(inverse):
    """A batch of 3 (not a power of two) size-16 transforms, and a
    two-dimensional batch."""
    vals = _values(20, 3 * 16)
    jx = JFR.encode_vec(vals).reshape(3, 16, JFR.L)
    x = FR.from_limbs16(np.asarray(jx))
    got = tntt.ntt_batch(x, inverse=inverse)
    assert np.array_equal(FR.to_limbs16(got),
                          np.asarray(jntt.ntt_batch(jx, inverse=inverse)))
    ref = o.intt if inverse else o.ntt
    for i in range(3):
        assert FR.decode(got[i]) == ref(vals[16 * i:16 * (i + 1)])
    x2 = x[:2].reshape(2, 2, 8, FR.L)
    got2 = tntt.ntt_batch(x2, inverse=inverse)
    assert FR.decode(got2[1, 0]) == ref(vals[16:24])


def test_size_one_and_caches():
    x = FR.encode([5])
    assert FR.decode(tntt.ntt(x)) == [5] and FR.decode(tntt.intt(x)) == [5]
    assert tntt.root_of_unity(4) == o.fr_root_of_unity(4)
    assert tntt.root_of_unity(4) * tntt.root_of_unity(4, True) % o.R == 1
    tw = tntt.twiddles(4, False)
    assert tw is tntt.twiddles(4, False) and tw.shape == (8, FR.L)
    w = o.fr_root_of_unity(4)
    assert FR.decode(tw) == [pow(w, k, o.R) for k in range(8)]
    assert np.array_equal(FR.to_limbs16(tw),
                          np.asarray(jntt.twiddles(4, False)))
    rev = tntt._bit_reversal(3, "cpu")
    assert rev.tolist() == [0, 4, 2, 6, 1, 5, 3, 7]


@pytest.mark.parametrize("inverse", [False, True])
def test_butterfly_plain_matches_jax_bfly8_stage_by_stage(inverse):
    """Every stage of a size-16 transform: ``fr_butterfly_plain`` against the
    JAX package's ``_bfly8`` on the same even/odd/twiddle operands (laid out
    as ``_ntt_base8`` lays them out), and the chain of stages against the
    oracle."""
    log_n, n = 4, 16
    vals = _values(30, n)
    tw = tntt.twiddles(log_n, inverse)
    tw16 = FR.to_limbs16(tw)
    v = FR.encode(vals).index_select(0, tntt._bit_reversal(log_n, "cpu"))
    for stage in range(1, log_n + 1):
        half = 1 << (stage - 1)
        stride = (n // 2) // half
        blocks = FR.to_limbs16(v).reshape(n // (2 * half), 2, half, JFR.L)
        even = blocks[:, 0].reshape(n // 2, JFR.L)
        odd = blocks[:, 1].reshape(n // 2, JFR.L)
        wf = np.tile(tw16[::stride][:half], (n // (2 * half), 1))
        ab = jntt._bfly8(*(l8.to_lane8(jnp.asarray(a))
                           for a in (even, odd, wf)))
        ab = np.asarray(l8.from_lane8(ab), dtype=np.uint32)   # (2, n/2, 16)
        want = np.stack([ab[0].reshape(-1, half, JFR.L),
                         ab[1].reshape(-1, half, JFR.L)],
                        axis=1).reshape(n, JFR.L)
        v = tntt.fr_butterfly_plain(v, tw, stage)
        assert np.array_equal(FR.to_limbs16(v), want), stage
    want = o.ntt(vals, inverse)
    assert FR.decode(v) == want
