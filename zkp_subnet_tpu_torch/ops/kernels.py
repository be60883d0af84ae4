"""The port's hand-written Hopper kernels: build, binding, launch wrappers.

Sources live in ``zkp_subnet_tpu_torch/csrc/`` (K1 ``g1.cu``, K2 ``msm.cu``,
K3 ``fr.cu``, K4 ``fq.cu``, K5 ``ntt.cu``, headers ``mont.cuh``/``fq.cuh``/
``fr.cuh``/``g1.cuh``). On first CUDA use they are compiled with ``nvcc`` for
``sm_90a``, one process per source and all started together, and linked into
``build/zkp_subnet_tpu_torch/libzkp_kernels.so`` (a plain C interface, no
PyTorch headers) that is loaded with ``ctypes``. A stamp of the sources' hash
next to the library decides whether a rebuild is due. Nothing is compiled or
loaded at import time.

Every wrapper below takes CUDA tensors only: it checks device, dtype, shape
and contiguity and raises on anything else, allocates its output with
``torch.empty``, adds one to ``LAUNCHES[name]`` and launches on PyTorch's
current stream. The C entry points return ``cudaGetLastError()``, and a
non-zero code raises. There is no fallback: the plain PyTorch versions are
chosen by the callers (ops/field.py, ops/curve.py, ops/msm.py) only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import msm_rounds

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "zkp_subnet_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libzkp_kernels.so")
SOURCES = ("g1.cu", "msm.cu", "fr.cu", "fq.cu", "ntt.cu")
HEADERS = ("mont.cuh", "fq.cuh", "fr.cuh", "g1.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last ``reset_launches()``
LAUNCHES = {name: 0 for name in ("g1_add", "g1_double", "msm_buckets",
                                 "msm_reduce", "msm_combine", "fr_mul",
                                 "fr_add", "fr_sub", "fq_mul", "fq_add",
                                 "fq_sub", "fr_butterfly")}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()


def build(force: bool = False) -> dict:
    """Compile the kernels unless an up-to-date library exists.

    Returns ``{"built": bool, "seconds": float, "log": str}``; ``log`` holds
    nvcc's ``-Xptxas -v`` report (registers, spills) when it built."""
    stamp = LIB_PATH + ".stamp"
    digest = _sources_hash()
    if not force and os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return {"built": False, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    objects = [os.path.join(BUILD_DIR, s + tag + ".o") for s in SOURCES]
    t0 = time.perf_counter()
    # one nvcc per source, all at once: the sources share no device symbol,
    # so each compiles alone and the slowest (msm.cu) sets the build time
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = LIB_PATH + tag
    try:
        for src, proc, out in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} ({proc.returncode}):\n{out}")
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in objects:
            if os.path.exists(path):
                os.remove(path)
    seconds = time.perf_counter() - t0
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    log = "".join(logs)
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
        f.write(log)
    return {"built": True, "seconds": seconds, "log": log}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        sigs = {
            "zkp_g1_add": [p, p, p, i64, p],
            "zkp_g1_double": [p, p, i64, p],
            "zkp_msm_buckets": [p, p, p, p, p, i32, i32, i32, p],
            "zkp_msm_reduce": [p, p, i32, i32, p],
            "zkp_msm_combine": [p, p, p, i32, i32, i32, i32, i32, i32, i32, p],
            "zkp_fr_mul": [p, p, p, i64, i32, i32, p],
            "zkp_fr_add": [p, p, p, i64, i32, i32, p],
            "zkp_fr_sub": [p, p, p, i64, i32, i32, p],
            "zkp_fq_mul": [p, p, p, i64, i32, i32, p],
            "zkp_fq_add": [p, p, p, i64, i32, i32, p],
            "zkp_fq_sub": [p, p, p, i64, i32, i32, p],
            "zkp_fr_butterfly": [p, p, i64, i32, i32, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype=torch.int32, tail=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tail is not None and tuple(t.shape[-len(tail):]) != tuple(tail):
        raise ValueError(f"{name}: expected shape (..., "
                         f"{', '.join(map(str, tail))}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(name: str, fn, *args) -> None:
    LAUNCHES[name] += 1
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# -- K1: csrc/g1.cu ------------------------------------------------------------

def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete RCB15 add of two (N, 3, 12) point tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (via
    dispatch_ladd). Bound: integer multiply throughput (~4,000 wide
    multiplies per add); one thread per point keeps the whole add in
    registers."""
    _check(p, "p", tail=(3, 12))
    _check(q, "q", tail=(3, 12))
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("g1_add: p and q must have one shape and device")
    out = torch.empty_like(p)
    n = p.numel() // 36
    if n:
        _launch("g1_add", _load().zkp_g1_add,
                p.data_ptr(), q.data_ptr(), out.data_ptr(), n)
    return out


def g1_double(p: torch.Tensor) -> torch.Tensor:
    """Complete RCB15 double of an (N, 3, 12) point tensor.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (via
    dispatch_ldouble). Bound and design as ``g1_add``."""
    _check(p, "p", tail=(3, 12))
    out = torch.empty_like(p)
    n = p.numel() // 36
    if n:
        _launch("g1_double", _load().zkp_g1_double,
                p.data_ptr(), out.data_ptr(), n)
    return out


# -- K2: csrc/msm.cu -----------------------------------------------------------

def msm_buckets(points, perm, starts, counts) -> torch.Tensor:
    """Bucket sums (rows, B, 3, 12) from sorted runs.

    ``points`` (N, 3, 12); ``perm`` (rows, row_len) int32 point indices in
    sorted-digit order; ``starts``/``counts`` (rows, B) int32 run offsets
    into a row and run lengths. Replaces zkp_subnet_tpu/ops/msm.py:
    _chunk_bucket_sums (XLA around pfield∘ZFQ). Bound: serial point adds
    per run (integer multiplies); one thread per (row, bucket). The rows of
    K MSMs over the same points go through one launch."""
    _check(points, "points", tail=(3, 12))
    _check(perm, "perm")
    _check(starts, "starts")
    _check(counts, "counts")
    if perm.dim() != 2 or starts.dim() != 2 or starts.shape != counts.shape \
            or starts.shape[0] != perm.shape[0]:
        raise ValueError("msm_buckets: perm (rows, row_len) and "
                         "starts/counts (rows, B) expected")
    rows, nb = starts.shape
    out = torch.empty((rows, nb, 3, 12), dtype=torch.int32,
                      device=points.device)
    if rows * nb:
        _launch("msm_buckets", _load().zkp_msm_buckets,
                points.data_ptr(), perm.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), out.data_ptr(), rows, perm.shape[1], nb)
    return out


def msm_reduce(buckets: torch.Tensor) -> torch.Tensor:
    """Σ_d d·B_d per row of (rows, B, 3, 12) buckets → (rows, 3, 12).

    Replaces zkp_subnet_tpu/ops/msm.py:_weighted_window_sums. Bound on this
    card: the chain of dependent point adds (latency), not bytes or
    multiplies. B / 8 lanes share a row: each walks a segment of 8 buckets
    with the running sum, then a suffix scan and tree sums across the lanes
    through shared memory (``ops/msm.py:reduce_depth`` point operations
    deep, 27 at 256 buckets; the running sum over a whole row is 510). B / 8
    must be a power of two in 2..128, or the launch is refused."""
    _check(buckets, "buckets", tail=(3, 12))
    if buckets.dim() != 4:
        raise ValueError("msm_reduce: expected (rows, B, 3, 12)")
    rows, nb = buckets.shape[:2]
    out = torch.empty((rows, 3, 12), dtype=torch.int32,
                      device=buckets.device)
    if rows:
        _launch("msm_reduce", _load().zkp_msm_reduce,
                buckets.data_ptr(), out.data_ptr(), rows, nb)
    return out


def msm_combine(window_sums: torch.Tensor, window_bits: int) -> torch.Tensor:
    """Horner over the windows, window W−1 first, for K chains at once:
    (K, W, 3, 12) → (K, 3, 12), or (W, 3, 12) → (3, 12).

    Replaces the Horner scan of zkp_subnet_tpu/ops/msm.py:msm (:384-392).
    Bound: one chain of W·(wb + 1) dependent point operations per MSM
    (latency); the chain's length is inherent, so one warp per chain makes
    each step short: in every round of the schedule of
    ``ops/msm_rounds.py`` up to six lanes do one Fq operation each, two
    rounds of products a point operation."""
    _check(window_sums, "window_sums", tail=(3, 12))
    if window_sums.dim() not in (3, 4):
        raise ValueError("msm_combine: expected (W, 3, 12) or (K, W, 3, 12)")
    prog = msm_rounds.program(window_sums.device)
    chains = window_sums.shape[0] if window_sums.dim() == 4 else 1
    out = torch.empty(window_sums.shape[:-3] + (3, 12), dtype=torch.int32,
                      device=window_sums.device)
    if chains:
        _launch("msm_combine", _load().zkp_msm_combine,
                window_sums.data_ptr(), out.data_ptr(),
                prog.table.data_ptr(), chains, window_sums.shape[-3],
                int(window_bits), prog.double_rounds,
                prog.table.shape[0] - prog.double_rounds,
                prog.table.shape[1], prog.slots)
    return out


# -- K3: csrc/fr.cu and K4: csrc/fq.cu -------------------------------------------

def _binary(name: str, limbs: int, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """An elementwise field op over (..., limbs) tensors; either operand may
    be a single element, which the kernel reads with a step of 0. The
    kernels move an element as 16-byte words."""
    _check(a, "a", tail=(limbs,))
    _check(b, "b", tail=(limbs,))
    if a.device != b.device:
        raise ValueError(f"{name}: operands on different devices")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    n = 1
    for d in shape[:-1]:
        n *= d
    na, nb = a.numel() // limbs, b.numel() // limbs
    if na not in (n, 1) or nb not in (n, 1):
        raise ValueError(f"{name}: operands must match or one must be a "
                         "single element")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if n:
        _launch(name, getattr(_load(), f"zkp_{name}"),
                a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                limbs if na == n else 0, limbs if nb == n else 0)
    return out


def fr_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery product a·b·2⁻²⁵⁶ mod r over (..., 8) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("mont_mul", BFR) (via
    poly._fmul). Bound: launch latency at the slice's 2^16 widths (128
    wide multiplies per element); one element per thread."""
    return _binary("fr_mul", 8, a, b)


def fr_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr addition over (..., 8) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("add", BFR) (via
    poly._fadd). Bound: bytes and launch latency (log2 N launches per
    suffix sum); one element per thread."""
    return _binary("fr_add", 8, a, b)


def fr_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fr subtraction a − b mod r over (..., 8) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("sub", BFR) (the
    differences β − ω^i and y_i − v of the Pianist aggregation). Bound:
    launch latency at the aggregation's widths (M elements); one element
    per thread."""
    return _binary("fr_sub", 8, a, b)


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq Montgomery product a·b·2⁻³⁸⁴ mod q over (..., 12) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("mont_mul", BFQ) and
    _pmul1 → pmul. Bound: 288 wide multiply-adds against 144 bytes per
    element, about even on the card; launch latency below ~2^17 elements.
    One element per thread."""
    return _binary("fq_mul", 12, a, b)


def fq_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq addition over (..., 12) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("add", BFQ). Bound:
    bytes (144 per element); one element per thread."""
    return _binary("fq_add", 12, a, b)


def fq_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fq subtraction a − b mod q over (..., 12) tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("sub", BFQ). Bound:
    bytes (144 per element); one element per thread."""
    return _binary("fq_sub", 12, a, b)


# -- K5: csrc/ntt.cu -------------------------------------------------------------

def fr_butterfly(v: torch.Tensor, tw: torch.Tensor,
                 stage: int) -> torch.Tensor:
    """One DIT butterfly stage of a batched size-n NTT, IN PLACE on ``v``.

    ``v`` (..., n, 8) Montgomery values (bit-reversed order before stage 1),
    ``tw`` (n/2, 8) the table [w^0 .. w^(n/2−1)], ``stage`` in 1..log2 n:
    each pair (j, j + 2^(stage−1)) becomes (e + o·w, e − o·w). Returns ``v``.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pbutterfly. Bound: bytes (every
    element read and written once per stage); one thread per pair, 16-byte
    loads and stores, offsets worked out in the kernel."""
    _check(v, "v", tail=(8,))
    _check(tw, "tw", tail=(8,))
    if v.dim() < 2 or tw.dim() != 2 or v.device != tw.device:
        raise ValueError("fr_butterfly: v (..., n, 8) and tw (n/2, 8) on "
                         "one device expected")
    n = v.shape[-2]
    log_n = n.bit_length() - 1
    if n < 2 or 1 << log_n != n or tw.shape[0] != n // 2:
        raise ValueError("fr_butterfly: n must be a power of two ≥ 2 and "
                         "tw must hold n/2 twiddles")
    if not 1 <= stage <= log_n:
        raise ValueError(f"fr_butterfly: stage {stage} outside 1..{log_n}")
    if v.data_ptr() % 16 or tw.data_ptr() % 16:
        raise ValueError("fr_butterfly: tensors must be 16-byte aligned")
    rows = v.numel() // (8 * n)
    if rows:
        _launch("fr_butterfly", _load().zkp_fr_butterfly,
                v.data_ptr(), tw.data_ptr(), rows, log_n, int(stage))
    return v
