"""The port's hand-written Hopper kernels: build, binding, launch wrappers.

Sources live in ``zkp_subnet_tpu_torch/csrc/`` (K1 ``g1.cu``, K2 ``msm.cu``,
K3 ``fr.cu``, K4 ``fq.cu``, K5 ``ntt.cu``, headers ``mont.cuh``/``fq.cuh``/
``fr.cuh``/``g1.cuh``/``ptx.cuh``). On first CUDA use they are compiled with ``nvcc`` for
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
chosen by the callers (ops/field.py, ops/curve.py, ops/msm.py, ops/poly.py)
only for tensors on the CPU.

The loader is safe under threads (``runtime.LocalTransport`` and the HTTP
server call workers from several): the build, the load and every count
of ``LAUNCHES`` are taken under one lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from . import msm_rounds

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "zkp_subnet_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libzkp_kernels.so")
SOURCES = ("g1.cu", "msm.cu", "fr.cu", "fq.cu", "ntt.cu")
HEADERS = ("ptx.cuh", "mont.cuh", "fq.cuh", "fr.cuh", "g1.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last ``reset_launches()``
LAUNCHES = {name: 0 for name in ("g1_add", "g1_double", "g1_scalar_mul",
                                 "g1_fixed_table", "g1_msm_fixed",
                                 "msm_buckets", "msm_reduce", "msm_combine",
                                 "fr_mul", "fr_add", "fr_sub", "fr_inv",
                                 "fr_power_tables", "fr_powers",
                                 "fr_suffix_scan",
                                 "fr_open_quotient", "fr_eval_rows",
                                 "fq_mul", "fq_add", "fq_sub",
                                 "fr_butterfly")}

#: elements of one block's tile in the suffix scan (SCAN_TILE of
#: csrc/fr.cu, whose C entries refuse another)
SCAN_TILE = 512

#: entries of a level of the power tables (POW_WIDTH of csrc/fr.cuh, whose
#: C entries refuse another), and their levels at most (MAX_POW_LEVELS)
POW_WIDTH = 256
MAX_POW_LEVELS = 4

#: rows of one opening's launches at most (the grids' second dimension)
MAX_OPEN_ROWS = 65535

#: elements of one block's tile in ``fr_eval_rows`` (EVAL_TILE of
#: csrc/fr.cu, whose C entry refuses another), and the second pass's powers
#: of a point that its scratch holds (EVAL_POWERS)
EVAL_TILE = 2048
EVAL_POWERS = 33

#: rows of one ``fr_eval_rows`` launch at most (the grid's second dimension)
MAX_EVAL_ROWS = 65535

#: points at most that ``g1_scalar_mul`` takes in its group form (a point
#: a group of 8 lanes); above, a thread a point. The crossover of the two
#: forms on the H100 (PERF.md, kernel_ab.py)
LADDER_GROUP_MAX = 1 << 13

#: the fixed-base table of ``g1_fixed_table``: windows of 4 bits (signed
#: digits in [-7, 8]) and the multiples 1..8 of each window's base
#: (FIXED_WINDOWS and FIXED_MULTIPLES of csrc/g1.cu), and the inputs a block
#: of ``g1_msm_fixed``'s tree of launches sums (FIXED_FAN_IN): its C entry
#: refuses others
FIXED_DIGIT_BITS = 4
FIXED_WINDOWS = 256 // FIXED_DIGIT_BITS
FIXED_MULTIPLES = 1 << (FIXED_DIGIT_BITS - 1)
FIXED_FAN_IN = 32

#: MSMs of one ``g1_msm_fixed`` call at most (the grid's second dimension)
MAX_FIXED_MSMS = 65535

_lib = None
#: guards the build, the load and ``LAUNCHES``
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
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
    with _lock:
        return _build(force)


def _build(force: bool) -> dict:
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


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    nvcc's ``-Xptxas -v`` report. A kernel is keyed by its plain name, with
    the values of its template arguments where it has some:
    ``fr_binary_kernel<0>`` is ``fr_binary_kernel<MUL>``."""
    def plain(mangled):
        # the length-prefixed names of _ZN<len><name>...: the one that
        # ends in _kernel, then its template arguments I L<type><value>E ... E
        pos = 3 if mangled.startswith("_ZN") else 2
        while pos < len(mangled) and mangled[pos].isdigit():
            end = pos
            while mangled[end].isdigit():
                end += 1
            size = int(mangled[pos:end])
            name, pos = mangled[end:end + size], end + size
            if name.endswith("_kernel"):
                args = re.match(r"I((?:L(?:N\w*?E|\d+[A-Za-z_]\w*?|[a-z])"
                                r"n?\d+E)+)E", mangled[pos:])
                if args:
                    values = re.findall(r"(n?\d+)E", args.group(1))
                    name += "<" + ", ".join(
                        v.replace("n", "-") for v in values) + ">"
                return name
        return mangled

    usage, props, entry = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = plain(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = plain(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props[name] = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            stack, stores, loads = props.get(entry, (0, 0, 0))
            usage[entry] = {"registers": int(m.group(1)), "stack": stack,
                            "spill_stores": stores, "spill_loads": loads}
    return usage


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _build(False)
            _lib = _bind(ctypes.CDLL(LIB_PATH))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "zkp_g1_add": [p, p, p, i64, p],
        "zkp_g1_double": [p, p, i64, p],
        "zkp_g1_scalar_mul": [p, p, p, i64, i32, p],
        "zkp_g1_fixed_table": [p, p, i64, p],
        "zkp_g1_msm_fixed": [p, p, p, p, i32, i32, i32, i32, i32, p],
        "zkp_msm_buckets": [p, p, p, p, i32, i32, p],
        "zkp_msm_reduce": [p, p, i32, i32, p],
        "zkp_msm_combine": [p, p, p, i32, i32, i32, i32, i32, i32, i32, p],
        "zkp_fr_mul": [p, p, p, i64, i32, i32, p],
        "zkp_fr_add": [p, p, p, i64, i32, i32, p],
        "zkp_fr_sub": [p, p, p, i64, i32, i32, p],
        "zkp_fr_inv": [p, p, i64, p],
        "zkp_fr_power_tables": [p, p, p, i32, i32, p],
        "zkp_fr_powers": [p, p, p, i64, i64, i32, i32, p],
        "zkp_fr_suffix_scan": [p, p, p, i64, i32, p],
        "zkp_fr_open_quotient": [p, p, p, p, p, p, p, i64, i64, i32, i32,
                                 i32, p],
        "zkp_fr_eval_rows": [p, p, p, p, i64, i64, i64, i32, i32, p],
        "zkp_fq_mul": [p, p, p, i64, i32, i32, p],
        "zkp_fq_add": [p, p, p, i64, i32, i32, p],
        "zkp_fq_sub": [p, p, p, i64, i32, i32, p],
        "zkp_fr_butterfly": [p, p, i64, i32, i32, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


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


def _aligned(name: str, *tensors) -> None:
    """K3, K4, K5 and K1's double move an element or a point as 16-byte
    words."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _launch(name: str, fn, *args) -> None:
    with _lock:
        LAUNCHES[name] += 1
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# -- K1: csrc/g1.cu ------------------------------------------------------------

def g1_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete RCB15 add of two (N, 3, 12) point tensors.

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (via
    dispatch_ladd). Bound: integer multiply throughput (~4,100 32-bit
    multiply-adds per add); one thread per point keeps the whole add in
    registers, the field operations as carry chains, at 16 warps an SM."""
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
    """Complete RCB15 double of an (N, 3, 12) point tensor (16-byte
    aligned).

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ (via
    dispatch_ldouble) and _pdouble1 -> pdouble. Bound: integer multiplies
    (6 Fq products and 2 squares, ~2,500 operations a double). A thread a double in
    registers at 128 registers (16 warps an SM), the point moved as nine
    16-byte words each way (the 4-byte words of a warp's loads fell 144
    bytes apart and took half the time), Y² and Z² by the Montgomery
    squaring ``fq::sqr``. Measured against the point split over 2 and 4
    lanes (csrc/g1.cu's header)."""
    _check(p, "p", tail=(3, 12))
    out = torch.empty_like(p)
    _aligned("g1_double", p, out)
    n = p.numel() // 36
    if n:
        _launch("g1_double", _load().zkp_g1_double,
                p.data_ptr(), out.data_ptr(), n)
    return out


def ladder_grouped(n: int) -> bool:
    """Whether ``g1_scalar_mul`` runs n points in its group form (a point a
    group of 8 lanes: few points, bound by the chain's latency) rather than
    its thread form (a thread a point: many points, bound by the integer
    rate)."""
    return n <= LADDER_GROUP_MAX


def g1_scalar_mul(p: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """[k_i]P_i for (N, 3, 12) points and (N, 8) canonical int32 scalars
    (any 256-bit value).

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield over lazy8.ZFQ as
    reached through dispatch_ldouble/dispatch_ladd from curve.g1_scalar_mul
    (:373/:385). Bound: integer multiplies (bitlen(k) − 1 doubles and the
    adds of the best fixed window, a point); at a few thousand points the
    latency of a point's chain. One launch for the whole ladder over signed
    4-bit windows and a table P … 8P a point, built in the kernel: in its
    group form at N ≤ ``LADDER_GROUP_MAX`` (each step's products side by
    side on the lanes of a group), else a thread a point. Both forms give
    the limbs of ``curve.g1_scalar_mul_plain``."""
    _check(p, "p", tail=(3, 12))
    _check(scalars, "scalars", tail=(8,))
    if (p.shape[:-2] != scalars.shape[:-1]
            or p.device != scalars.device):
        raise ValueError("g1_scalar_mul: one scalar a point, on one device")
    n = p.numel() // 36
    return _ladder(p, scalars, ladder_grouped(n))


def _ladder(p: torch.Tensor, scalars: torch.Tensor,
            grouped: bool) -> torch.Tensor:
    """``g1_scalar_mul`` in the form named (checked inputs): for timing the
    two forms against each other at one N."""
    out = torch.empty_like(p)
    n = p.numel() // 36
    if n:
        _launch("g1_scalar_mul", _load().zkp_g1_scalar_mul, p.data_ptr(),
                scalars.data_ptr(), out.data_ptr(), n, int(grouped))
    return out


def fixed_passes(m: int) -> list:
    """The inputs of each launch of ``g1_msm_fixed``'s tree at m keys: the
    64·m terms, then each launch's block sums, down to one."""
    n = [FIXED_WINDOWS * m]
    while n[-1] > 1:
        n.append(-(-n[-1] // FIXED_FAN_IN))
    return n


def g1_fixed_table(p: torch.Tensor) -> torch.Tensor:
    """table[i, w, j] = [(j + 1)·16^w]P_i, w < 64, j < 8: (M, 3, 12) points
    → (M, 64, 8, 3, 12), the fixed-base table of ``g1_msm_fixed``
    (73,728 bytes a key).

    Replaces, with ``g1_msm_fixed``, pallas_g1.py:pfield over lazy8.ZFQ as
    the naive MSM reaches it (dispatch_ldouble). Bound: latency, the chain
    of 255 dependent doubles a key; built once per SRS and device. Two
    launches: a group of 4 lanes a key takes each double's products side
    by side (two in a row where one thread has eight), storing a window's
    B, 2B, 4B and 8B on the way; then a thread an entry makes 3B, 5B, 6B
    and 7B by one add each."""
    _check(p, "p", tail=(3, 12))
    if p.dim() != 3:
        raise ValueError("g1_fixed_table: expected (M, 3, 12)")
    out = torch.empty((p.shape[0], FIXED_WINDOWS, FIXED_MULTIPLES, 3, 12),
                      dtype=torch.int32, device=p.device)
    if p.shape[0]:
        _launch("g1_fixed_table", _load().zkp_g1_fixed_table,
                p.data_ptr(), out.data_ptr(), p.shape[0])
    return out


def g1_msm_fixed(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """K MSMs Σ_i k_{c,i}·P_i over the bases of a fixed-base table:
    ``table`` (M, 64, 8, 3, 12) from ``g1_fixed_table``, ``scalars`` (K, M,
    8) canonical int32 (below 2^255) → (K, 3, 12), any M ≥ 1.

    Replaces pallas_g1.py:pfield over lazy8.ZFQ as reached from
    zkp_subnet_tpu/ops/msm.py:msm_auto's naive path (a ladder a point and a
    tree sum: the Pianist aggregation's C_y and W_y). Bound: latency, the
    chain of dependent point adds. An MSM is the sum of its 64·M terms,
    each a table entry by its signed 4-bit digit (no doubles), by a tree of
    launches (``fixed_passes``): a block sums 32 inputs by a halving tree of
    adds, each add's products side by side on 6 lanes of a warp; log2(64·M)
    adds deep."""
    _check(table, "table", tail=(FIXED_WINDOWS, FIXED_MULTIPLES, 3, 12))
    _check(scalars, "scalars", tail=(8,))
    if (table.dim() != 5 or scalars.dim() != 3
            or scalars.shape[1] != table.shape[0]
            or table.device != scalars.device):
        raise ValueError("g1_msm_fixed: table (M, 64, 8, 3, 12) and scalars "
                         "(K, M, 8) on one device expected")
    k, m = scalars.shape[:2]
    if not 1 <= k <= MAX_FIXED_MSMS or m < 1:
        raise ValueError(f"g1_msm_fixed: 1..{MAX_FIXED_MSMS} MSMs of at "
                         "least one base expected")
    passes = fixed_passes(m)
    scratch = torch.empty((k, sum(passes[1:3]), 3, 12), dtype=torch.int32,
                          device=table.device)
    out = torch.empty((k, 3, 12), dtype=torch.int32, device=table.device)
    _launch("g1_msm_fixed", _load().zkp_g1_msm_fixed, table.data_ptr(),
            scalars.data_ptr(), scratch.data_ptr(), out.data_ptr(), k, m,
            FIXED_WINDOWS, FIXED_MULTIPLES, FIXED_FAN_IN)
    return out


# -- K2: csrc/msm.cu -----------------------------------------------------------

def msm_buckets(points, perm, digits) -> torch.Tensor:
    """Bucket sums (rows, 256, 3, 12) from digit-sorted rows.

    ``points`` (N, 3, 12); ``perm`` (rows, n) int32 point indices and
    ``digits`` (rows, n) uint8, each row in ascending digit order. Replaces
    zkp_subnet_tpu/ops/msm.py:_chunk_bucket_sums (XLA around pfield∘ZFQ).
    Bound: integer multiplies (point adds). One block a row, each thread a
    fixed tile of ceil(n / 256) entries, then a segmented scan across the
    tiles: no thread's work depends on the digits. The rows of K MSMs over
    the same points go through one launch."""
    _check(points, "points", tail=(3, 12))
    _check(perm, "perm")
    _check(digits, "digits", dtype=torch.uint8)
    if perm.dim() != 2 or digits.shape != perm.shape:
        raise ValueError("msm_buckets: perm and digits (rows, n) expected")
    rows, n = perm.shape
    out = torch.empty((rows, 256, 3, 12), dtype=torch.int32,
                      device=points.device)
    if rows:
        _launch("msm_buckets", _load().zkp_msm_buckets,
                points.data_ptr(), perm.data_ptr(), digits.data_ptr(),
                out.data_ptr(), rows, n)
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
    _aligned(name, a, b)
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


def _one_element(t: torch.Tensor, name: str) -> None:
    _check(t, name, tail=(8,))
    if t.numel() != 8:
        raise ValueError(f"{name}: expected one Fr element")


def fr_inv(a: torch.Tensor) -> torch.Tensor:
    """1/a over (..., 8) Montgomery tensors; 0 ↦ 0. VARIABLE TIME: public
    inputs only (an opening's point, the aggregation's β − ω^i).

    Replaces zkp_subnet_tpu/ops/pallas_g1.py:pfield("mont_mul", BFR) as
    reached from field.inv → pow_static (Fermat's a^(r−2), 418 products).
    Bound: latency, one thread's chain of dependent steps. One launch, one
    thread an element: Kaliski's binary inverse on the limbs (~180 steps
    of carry chains and shifts, where Fermat's chain is 417 products),
    then two Montgomery products (csrc/fr.cuh)."""
    _check(a, "a", tail=(8,))
    _aligned("fr_inv", a)
    out = torch.empty_like(a)
    n = a.numel() // 8
    if n:
        _launch("fr_inv", _load().zkp_fr_inv, a.data_ptr(), out.data_ptr(), n)
    return out


def power_levels(n: int, width: int = POW_WIDTH) -> int:
    """Levels of a power table of ``width`` (a power of two) entries a level
    that hold x^e for every e < n (at least one)."""
    bits = width.bit_length() - 1
    return max(1, -(-max(n - 1, 0).bit_length() // bits))


def fr_power_tables(x: torch.Tensor, n: int,
                    xi: torch.Tensor | None = None) -> torch.Tensor:
    """The tables of powers that ``fr_powers`` (of x) and
    ``fr_open_quotient`` (of ``xi`` = 1/x) read for rows of n elements:
    (1, or 2 with xi, levels, POW_WIDTH, 8), levels = ``power_levels(n)``.
    Table t, level l, entry i: (x or xi)^(i·256^l), Montgomery, but level 0
    of xi's table canonical (the quotient's product by the integer 1,
    folded in).

    ``x``, ``xi`` one element each on the card (read there). Replaces
    pallas_g1.py:pfield("mont_mul", BFR) as reached from field.powers
    (the doubling launches of the powers). Bound: latency, ~9 dependent
    products a level (a block's Hillis-Steele product scan of a level, then
    the next level's base); one block a point, once for all its rows."""
    _one_element(x, "x")
    tensors = [x]
    if xi is not None:
        _one_element(xi, "xi")
        if xi.device != x.device:
            raise ValueError("fr_power_tables: x and xi on different devices")
        tensors.append(xi)
    _aligned("fr_power_tables", *tensors)
    n = int(n)
    if not 0 <= n < 1 << 31:
        raise ValueError("fr_power_tables: n must be in [0, 2^31)")
    levels = power_levels(n)
    out = torch.empty((len(tensors), levels, POW_WIDTH, 8), dtype=torch.int32,
                      device=x.device)
    _launch("fr_power_tables", _load().zkp_fr_power_tables, x.data_ptr(),
            None if xi is None else xi.data_ptr(), out.data_ptr(), levels,
            POW_WIDTH)
    return out


def _table(table: torch.Tensor, n: int, name: str) -> int:
    """The levels of a (levels, POW_WIDTH, 8) table that reaches the powers
    below n; raises on anything else."""
    _check(table, "table", tail=(POW_WIDTH, 8))
    levels = table.shape[0]
    if table.dim() != 3 or not 1 <= levels <= MAX_POW_LEVELS:
        raise ValueError(f"{name}: a table (levels, {POW_WIDTH}, 8) of 1.."
                         f"{MAX_POW_LEVELS} levels expected")
    if levels < power_levels(n):
        raise ValueError(f"{name}: a table of {levels} levels does not reach "
                         f"{n} powers ({power_levels(n)} needed)")
    return levels


def fr_powers(table: torch.Tensor, n: int,
              c: torch.Tensor | None = None) -> torch.Tensor:
    """out_{b,k} = x^k·c_{b,k} (x^k without ``c``), k < n: (n, 8), or c's
    shape, (n, 8) or (B, n, 8) rows; Montgomery.

    ``table``: x's table from ``fr_power_tables`` (its first), on the card.
    Replaces pallas_g1.py:pfield("mont_mul", BFR) as reached from
    field.powers and poly._powers_lane/_fmul (log2 n doubling launches and
    the termwise product). Bound: bytes (c read, out written once). One
    thread a power k: its lookup in the table (a product a level above the
    first), then the product by c_{b,k} for a few rows b in turn; one launch
    for every row."""
    n = int(n)
    if not 0 <= n < 1 << 31:
        raise ValueError("fr_powers: n must be in [0, 2^31)")
    levels = _table(table, n, "fr_powers")
    rows = 1
    tensors = [table]
    if c is not None:
        _check(c, "c", tail=(8,))
        if (c.dim() not in (2, 3) or c.shape[-2] != n
                or c.device != table.device):
            raise ValueError("fr_powers: c must be (n, 8) or (B, n, 8) on the "
                             "table's device")
        rows = c.shape[0] if c.dim() == 3 else 1
        if not 1 <= rows <= MAX_OPEN_ROWS:
            raise ValueError(f"fr_powers: 1..{MAX_OPEN_ROWS} rows expected")
        tensors.append(c)
    _aligned("fr_powers", *tensors)
    out = torch.empty((n, 8) if c is None else tuple(c.shape),
                      dtype=torch.int32, device=table.device)
    if n:
        _launch("fr_powers", _load().zkp_fr_powers, table.data_ptr(),
                None if c is None else c.data_ptr(), out.data_ptr(), rows, n,
                levels, POW_WIDTH)
    return out


def fr_suffix_scan(terms: torch.Tensor):
    """First pass of the suffix scan over (n, 8) elements: (local (n, 8),
    totals (ceil(n / SCAN_TILE), 8)), each tile's inclusive suffix sums
    from its right end and its total.

    Replaces pallas_g1.py:pfield("add", BFR) as reached from
    poly._suffix_sums (log2 n Hillis-Steele launches). Bound: bytes and an
    add an element; an element a thread, consecutive lanes on consecutive
    elements, a warp's by shuffles, the warps' totals by one warp's
    shuffles."""
    _check(terms, "terms", tail=(8,))
    if terms.dim() != 2:
        raise ValueError("fr_suffix_scan: expected (n, 8)")
    _aligned("fr_suffix_scan", terms)
    n = terms.shape[0]
    local = torch.empty_like(terms)
    totals = torch.empty((-(-n // SCAN_TILE), 8), dtype=torch.int32,
                         device=terms.device)
    if n:
        _launch("fr_suffix_scan", _load().zkp_fr_suffix_scan,
                terms.data_ptr(), local.data_ptr(), totals.data_ptr(), n,
                SCAN_TILE)
    return local, totals


def fr_open_quotient(local: torch.Tensor, totals: torch.Tensor,
                     x: torch.Tensor, xi_table: torch.Tensor,
                     coeffs: torch.Tensor):
    """Second pass of the suffix scan, fused with the openings of B rows at
    one x: (y (8,) or (B, 8) Montgomery, q like ``local`` canonical) with
    y_b = S_{b,0} and q_{b,j} = S_{b,j+1}·xi^(j+1) (q_{b,n−1} = 0); at x = 0,
    q_b = c_b[1:] ‖ 0, chosen on the card.

    ``local`` (n, 8) or (B, n, 8) and ``totals`` (ceil(n / SCAN_TILE), 8) or
    (B, ·, 8) from ``fr_suffix_scan``, ``x`` one element, ``xi_table`` 1/x's
    table (the second of ``fr_power_tables``), ``coeffs`` like ``local``.
    Replaces pallas_g1.py:pfield over BFR as reached from
    poly.poly_open_scalars (the quotient scaling, the de-Montgomery product,
    the x = 0 select). Bound: bytes (local read, q written once); one thread
    an element: the carry over the tiles to the right by one warp a block,
    xi^(j+1) by a lookup in the table, an add and a product."""
    for t, name in ((local, "local"), (totals, "totals"), (coeffs, "coeffs")):
        _check(t, name, tail=(8,))
    _one_element(x, "x")
    batched = local.dim() == 3
    if local.dim() not in (2, 3):
        raise ValueError("fr_open_quotient: local (n, 8) or (B, n, 8) "
                         "expected")
    rows = local.shape[0] if batched else 1
    n = local.shape[-2]
    lead = (rows,) if batched else ()
    if (tuple(coeffs.shape) != tuple(local.shape)
            or tuple(totals.shape) != lead + (-(-n // SCAN_TILE), 8)):
        raise ValueError("fr_open_quotient: coeffs like local, totals "
                         "([B,] ceil(n / SCAN_TILE), 8) expected")
    if not 1 <= rows <= MAX_OPEN_ROWS:
        raise ValueError(f"fr_open_quotient: 1..{MAX_OPEN_ROWS} rows "
                         "expected")
    levels = _table(xi_table, n, "fr_open_quotient")
    if len({t.device for t in (local, totals, x, xi_table, coeffs)}) != 1:
        raise ValueError("fr_open_quotient: tensors on different devices")
    _aligned("fr_open_quotient", local, totals, x, xi_table, coeffs)
    y = torch.empty(lead + (8,), dtype=torch.int32, device=local.device)
    q = torch.empty_like(local)
    if n:
        _launch("fr_open_quotient", _load().zkp_fr_open_quotient,
                local.data_ptr(), totals.data_ptr(), x.data_ptr(),
                xi_table.data_ptr(), coeffs.data_ptr(), y.data_ptr(),
                q.data_ptr(), rows, n, levels, SCAN_TILE, POW_WIDTH)
    return y, q


def fr_eval_rows(coeffs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """y_r = Σ_k c_{r,k}·x_r^k: (R, 8) Montgomery from ``coeffs`` (R, n, 8)
    and ``xs`` (R, 8), Montgomery; either may hold one row or one point for
    all R (the kernel reads it with a step of 0).

    Replaces pallas_g1.py:pfield over lane8.BFR as poly._fmul and
    poly._tree_sum_lane reach it from poly_eval (the challenge's jax.vmap,
    zkp_subnet_tpu/runtime/coordinator.py:91). Bound: bytes, n·32 B a row.
    One call: a pass of per-(row, tile) partial sums (a lane's Horner run
    over the coefficients 32 apart, times x^lane, summed by shuffles; a
    tile's warps joined by a tree of Horner steps), then one warp a row
    joining the partials the same way; a row of one tile skips the second.
    About one Fr product an element; no inverse, no scan, no quotient,
    nothing read back to the host."""
    _check(coeffs, "coeffs", tail=(8,))
    _check(xs, "xs", tail=(8,))
    if coeffs.dim() != 3 or xs.dim() != 2 or coeffs.device != xs.device:
        raise ValueError("fr_eval_rows: coeffs (R, n, 8) and xs (R, 8) on "
                         "one device expected")
    rows_c, n = coeffs.shape[:2]
    rows_x = xs.shape[0]
    rows = max(rows_c, rows_x)
    if rows_c not in (rows, 1) or rows_x not in (rows, 1):
        raise ValueError("fr_eval_rows: as many rows as points, or one of "
                         "either")
    if not 1 <= rows <= MAX_EVAL_ROWS or not 0 <= n < 1 << 31:
        raise ValueError(f"fr_eval_rows: 1..{MAX_EVAL_ROWS} rows of fewer "
                         "than 2^31 coefficients expected")
    _aligned("fr_eval_rows", coeffs, xs)
    if n == 0:                                  # the empty sum
        return torch.zeros((rows, 8), dtype=torch.int32, device=xs.device)
    out = torch.empty((rows, 8), dtype=torch.int32, device=xs.device)
    tiles = -(-n // EVAL_TILE)
    x_step = 8 if rows_x == rows else 0
    # every (row, tile)'s partial sum, then the second pass's powers of
    # each point
    points = rows if x_step else 1
    scratch = (torch.empty((rows * tiles + points * EVAL_POWERS, 8),
                           dtype=torch.int32, device=xs.device)
               if tiles > 1 else None)
    _launch("fr_eval_rows", _load().zkp_fr_eval_rows, coeffs.data_ptr(),
            xs.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), rows, n, 8 * n if rows_c == rows else 0, x_step,
            EVAL_TILE)
    return out


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
    _aligned("fr_butterfly", v, tw)
    rows = v.numel() // (8 * n)
    if rows:
        _launch("fr_butterfly", _load().zkp_fr_butterfly,
                v.data_ptr(), tw.data_ptr(), rows, log_n, int(stage))
    return v
