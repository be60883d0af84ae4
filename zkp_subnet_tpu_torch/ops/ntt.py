"""Radix-2 NTT / iNTT over Fr on torch tensors.

The contract of ``zkp_subnet_tpu/ops/ntt.py``: (..., N, 8) int32 Montgomery
values, natural order in and out; forward out[k] = f(w^k) from coefficients,
the inverse scales by 1/n. It matches the reference prover's
``fft(poly, left, inverse)`` RPC.

A transform's result is unique, so the route is free, and the TPU's one
(Bailey four-step split, the (L8, n, R) byte-lane layout, ``BASE_LOG``,
twiddle tables passed as arguments) answers the TPU's layout and compile
path and is not carried over. Here a transform is a bit-reversal gather
followed by log2 N in-place decimation-in-time stages, each one launch of
kernel K5 ``fr_butterfly`` (``csrc/ntt.cu``) over the whole batch on the
card, or ``fr_butterfly_plain`` (the same stage by tensor reshapes over the
plain Fr ops) on the CPU; the inverse's 1/n is one K3 ``fr_mul`` by a
broadcast constant. Twiddle tables and bit-reversal indices are cached per
(log n, inverse, device).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import kernels
from .field import FR
from ..utils import oracle as o

_twiddle_cache: Dict[Tuple[int, bool, str], torch.Tensor] = {}
_bitrev_cache: Dict[Tuple[int, str], torch.Tensor] = {}


def root_of_unity(log_n: int, inverse: bool = False) -> int:
    w = o.fr_root_of_unity(log_n)
    return pow(w, o.R - 2, o.R) if inverse else w


def twiddles(log_n: int, inverse: bool, device=None) -> torch.Tensor:
    """[w^0 .. w^(n/2-1)] in Montgomery form, shape (n/2, 8). Cached."""
    key = (log_n, inverse, str(torch.device(device or "cpu")))
    if key not in _twiddle_cache:
        w = FR.encode([root_of_unity(log_n, inverse)], device)[0]
        _twiddle_cache[key] = FR.powers(
            w, max(1 << (log_n - 1), 1)).contiguous()
    return _twiddle_cache[key]


def _bit_reversal(log_n: int, device) -> torch.Tensor:
    """The int64 index vector that puts element bitrev(i) at i. Cached."""
    key = (log_n, str(torch.device(device)))
    if key not in _bitrev_cache:
        idx = torch.arange(1 << log_n, device=device)
        rev = torch.zeros_like(idx)
        for b in range(log_n):
            rev |= ((idx >> b) & 1) << (log_n - 1 - b)
        _bitrev_cache[key] = rev
    return _bitrev_cache[key]


def fr_butterfly_plain(v: torch.Tensor, tw: torch.Tensor,
                       stage: int) -> torch.Tensor:
    """Plain version of K5 ``fr_butterfly``: stage ``stage`` (1-based) of
    the DIT network on (..., n, 8), as a NEW tensor: pairs
    (j, j + half), half = 2^(stage−1), become (e + o·w, e − o·w) with
    w = tw[(j mod half)·(n/2)/half]."""
    n = v.shape[-2]
    half = 1 << (stage - 1)
    stride = (n // 2) // half
    blocks = v.reshape(v.shape[:-2] + (n // (2 * half), 2, half, FR.L))
    even, odd = blocks[..., 0, :, :], blocks[..., 1, :, :]
    t = FR.mont_mul_plain(odd, tw[::stride][:half])
    out = torch.stack([FR.add_plain(even, t), FR.sub_plain(even, t)], dim=-3)
    return out.reshape(v.shape)


def fr_butterfly(v: torch.Tensor, tw: torch.Tensor,
                 stage: int) -> torch.Tensor:
    """One DIT stage: K5 on a CUDA tensor (in place, ``v`` is returned), the
    plain version on the CPU (a new tensor)."""
    if v.is_cuda or tw.is_cuda:
        return kernels.fr_butterfly(v, tw, stage)
    return fr_butterfly_plain(v, tw, stage)


def ntt_batch(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Batched NTT over axis -2 of (..., N, 8): one K5 launch per stage
    covers every transform of the batch."""
    n = x.shape[-2]
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    if log_n == 0:
        return x.clone()
    # the gather makes a fresh contiguous tensor, which the stages update
    # in place on the card
    v = x.index_select(-2, _bit_reversal(log_n, x.device))
    tw = twiddles(log_n, inverse, x.device)
    for stage in range(1, log_n + 1):
        v = fr_butterfly(v, tw, stage)
    if inverse:
        n_inv = FR.encode([pow(n, o.R - 2, o.R)], x.device)
        v = FR.mont_mul(v, n_inv)
    return v


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT/iNTT of (N, 8) Montgomery-form values; natural order in and out.

    Forward: out[k] = f(w^k) from coefficients. Inverse includes 1/n scaling.
    """
    return ntt_batch(x, inverse)


def intt(x: torch.Tensor) -> torch.Tensor:
    return ntt(x, inverse=True)
