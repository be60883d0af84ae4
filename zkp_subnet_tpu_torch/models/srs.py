"""KZG structured reference string: generation, worker slices, persistence.

Port of ``zkp_subnet_tpu/models/srs.py``. *Setup* = the monomial τ_X powers
in G1 and τ_X, τ_Y in G2; *precompute* = the per-worker Pianist slices
U_i[j] = [R_i(τ_Y)·τ_X^j]G1 and the keys V_i = [R_i(τ_Y)]G1 (M = 2^machines_
scale workers, rows of T = 2^(scale − machines_scale) coefficients).

Generation: powers of τ_X by ``FR.powers`` (K3 ``fr_power_tables`` and
``fr_powers``), the
Lagrange values R_i(τ_Y) with host bigints, then the fixed-base comb
(``ops/curve.g1_fixed_base_mul``: a table gather and one K1 ``g1_add`` per
8-bit window) over all scalars. The comb runs in chunks of ``GEN_CHUNK``
scalars only to bound device memory (the digits and the gathered rows of a
chunk); unlike the JAX package there is no compiled shape to keep fixed, so
nothing is padded to a power of two and no chunk passes through the host.

Files are the JAX package's: two ``.npz`` files and, above
``_SIDE_CAR_LIMIT`` coefficients or from ``generate_to_disk``, a
``<precompute>.bases.npy`` sidecar, points as (…, 3, 24) uint32 16-bit limbs
(Montgomery). Each package loads what the other wrote; ``from_numpy_points``
/ ``to_numpy_points`` and ``Srs.from_numpy`` / ``Srs.to_numpy`` carry the
arrays across.

Entry points (``generate``, ``generate_to_disk``, ``load``, ``from_numpy``)
take ``device=None`` to mean the CUDA device and raise without one; a caller
that wants the CPU says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import List, Mapping, Optional

import numpy as np
import torch

from ..ops import curve as cv
from ..ops import msm as tmsm
from ..ops.field import FQ, FR
from ..utils import encoding as enc
from ..utils import oracle as o

FORMAT_VERSION = 1

#: scalars per fixed-base chunk during generation — bounds device memory to
#: about chunk·(32·8 B of digits + 3 point buffers of 144 B) at any scale
GEN_CHUNK = 1 << 16

#: where an ``Srs`` keeps its Lagrange-Y keys' window table (not a field:
#: derived state, never written)
_LAGRANGE_TABLE = "_lagrange_table"


def entry_device(device=None) -> torch.device:
    """The device of an entry point: ``None`` means the CUDA device, and is
    an error where there is none (no entry point picks the CPU unasked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def from_numpy_points(arr, device=None) -> torch.Tensor:
    """(…, 3, 24) uint32 16-bit limbs (JAX format) → (…, 3, 12) int32."""
    return FQ.from_limbs16(arr, device)


def to_numpy_points(t: torch.Tensor) -> np.ndarray:
    """(…, 3, 12) int32 → (…, 3, 24) uint32 16-bit limbs (JAX format)."""
    return FQ.to_limbs16(t)


def _fixed_base_chunked(scalars_canonical: torch.Tensor) -> torch.Tensor:
    """[k]G for (N, 8) canonical scalars via the comb tables, ``GEN_CHUNK``
    scalars at a time (the last chunk as short as it is)."""
    tables = cv.g1_fixed_base_tables(device=scalars_canonical.device)
    n = scalars_canonical.shape[0]
    if n <= GEN_CHUNK:
        return cv.g1_fixed_base_mul(tables, scalars_canonical)
    out = torch.empty((n, 3, FQ.L), dtype=torch.int32,
                      device=scalars_canonical.device)
    for off in range(0, n, GEN_CHUNK):
        out[off:off + GEN_CHUNK] = cv.g1_fixed_base_mul(
            tables, scalars_canonical[off:off + GEN_CHUNK])
    return out


def _lagrange_coeffs_at(tau_y: int, m: int) -> List[int]:
    """R_i(τ_Y) for the size-m roots-of-unity domain, i = 0..m-1.

    R_i(Y) = (Y^m - 1)·ω^i / (m·(Y - ω^i)); host bigints (m ≤ 2^8 in
    practice).
    """
    log_m = m.bit_length() - 1
    w = o.fr_root_of_unity(log_m)
    num = (pow(tau_y, m, o.R) - 1) % o.R
    minv = pow(m, o.R - 2, o.R)
    out = []
    for i in range(m):
        wi = pow(w, i, o.R)
        denom = (tau_y - wi) % o.R
        if denom == 0:
            # τ_Y hit the domain (astronomically unlikely); L_i(τ) = δ
            out.append(1 if wi == tau_y else 0)
            continue
        out.append(num * wi % o.R * minv % o.R
                   * pow(denom, o.R - 2, o.R) % o.R)
    return out


def _trapdoor(tau_x: Optional[int], tau_y: Optional[int], seed: int):
    """(τ_X, τ_Y): the given values, else the draws of the JAX package."""
    rnd = random.Random(seed + 0x5E70)
    if tau_x is None:
        tau_x = rnd.randrange(1, o.R)
    if tau_y is None:
        tau_y = rnd.randrange(1, o.R)
    return tau_x, tau_y


def _g2_bytes(p) -> np.ndarray:
    return np.frombuffer(enc.g2_to_bytes(p, False), dtype=np.uint8)


@dataclasses.dataclass
class Srs:
    """Device-resident SRS (the fields of ``zkp_subnet_tpu.models.srs.Srs``).

    g1_x: (T, 3, 12) — [τ_X^j]G1; worker_bases: (M, T, 3, 12) —
    [R_i(τ_Y)·τ_X^j]G1 (after ``load(lazy=True)`` of a sidecar: a read-only
    host memmap in the file format); lagrange_y: (M, 3, 12) — [R_i(τ_Y)]G1;
    g2_gen / g2_tau_x / g2_tau_y: host oracle G2 points.
    """
    scale: int
    machines_scale: int
    g1_x: torch.Tensor
    worker_bases: torch.Tensor
    lagrange_y: torch.Tensor
    g2_gen: tuple
    g2_tau_x: tuple
    g2_tau_y: tuple

    @property
    def machines(self) -> int:
        return 1 << self.machines_scale

    @property
    def row_size(self) -> int:
        return 1 << (self.scale - self.machines_scale)

    @property
    def device(self) -> torch.device:
        return self.g1_x.device

    def device_worker_bases(self, i: int) -> torch.Tensor:
        """Worker i's base slice on the device, contiguous. A lazy (memmap)
        slice is transferred on first use and cached per worker, so a worker
        process holds only the rows it proves."""
        if isinstance(self.worker_bases, torch.Tensor):
            return self.worker_bases[i]
        cache = self.__dict__.setdefault("_dev_bases", {})
        if i not in cache:
            cache[i] = from_numpy_points(
                np.ascontiguousarray(self.worker_bases[i]), self.device)
        return cache[i]

    def lagrange_table(self) -> torch.Tensor:
        """The window table of ``lagrange_y`` (``msm.fixed_table``: (M, 64,
        8, 3, 12), [(j + 1)·16^w]·V_i; 73,728 bytes a key, 18.9 MB at M =
        256, 75.5 MB at 1024) that the aggregation's MSMs read: built on
        first use, on the SRS's device, and kept. It is derived state: never
        written to the SRS files. A shard of the multi-device prove holds
        the table of all M keys (``keep_lagrange_table``)."""
        if _LAGRANGE_TABLE not in self.__dict__:
            self.keep_lagrange_table(self.lagrange_y)
        return self.__dict__[_LAGRANGE_TABLE]

    def keep_lagrange_table(self, keys: torch.Tensor) -> None:
        """Build the window table of ``keys`` (all M Lagrange-Y keys, on
        this SRS's device) and keep it as ``lagrange_table()``: a shard of
        the multi-device prove (``parallel.pianist.shard_srs``) whose
        ``lagrange_y`` holds its own rows only, since the aggregation runs
        on every rank over all M."""
        self.__dict__[_LAGRANGE_TABLE] = tmsm.fixed_table(keys)

    # -- carriers ------------------------------------------------------------

    @classmethod
    def from_numpy(cls, fields: Mapping, device=None) -> "Srs":
        """An SRS from the fields of the JAX package's ``Srs`` as numpy
        ((…, 3, 24) uint32 point arrays, the scales, the three G2 points)."""
        device = entry_device(device)
        return cls(
            scale=int(fields["scale"]),
            machines_scale=int(fields["machines_scale"]),
            g1_x=from_numpy_points(fields["g1_x"], device),
            worker_bases=from_numpy_points(fields["worker_bases"], device),
            lagrange_y=from_numpy_points(fields["lagrange_y"], device),
            g2_gen=fields["g2_gen"], g2_tau_x=fields["g2_tau_x"],
            g2_tau_y=fields["g2_tau_y"])

    def to_numpy(self) -> dict:
        """The inverse of ``from_numpy``."""
        bases = self.worker_bases
        return dict(
            scale=self.scale, machines_scale=self.machines_scale,
            g1_x=to_numpy_points(self.g1_x),
            worker_bases=(to_numpy_points(bases)
                          if isinstance(bases, torch.Tensor)
                          else np.asarray(bases)),
            lagrange_y=to_numpy_points(self.lagrange_y),
            g2_gen=self.g2_gen, g2_tau_x=self.g2_tau_x,
            g2_tau_y=self.g2_tau_y)

    # -- generation ----------------------------------------------------------

    @classmethod
    def generate(cls, scale: int, machines_scale: int,
                 tau_x: Optional[int] = None, tau_y: Optional[int] = None,
                 seed: int = 0, device=None) -> "Srs":
        """Generate a fresh SRS (trusted-setup emulation, parity with
        ``fourier setup --generate-setup --generate-precompute``)."""
        device = entry_device(device)
        tau_x, tau_y = _trapdoor(tau_x, tau_y, seed)
        m = 1 << machines_scale
        t = 1 << (scale - machines_scale)

        pow_x = FR.powers(FR.encode([tau_x], device)[0], t)     # (t, 8)
        lag_mont = FR.encode(_lagrange_coeffs_at(tau_y, m), device)
        # U_i[j] scalars R_i(τ_Y)·τ_X^j: one broadcast multiply per worker
        rows = [FR.mont_mul(pow_x, lag_mont[i]) for i in range(m)]
        all_scalars = FR.from_mont(torch.cat([pow_x, *rows, lag_mont]))
        all_points = _fixed_base_chunked(all_scalars)

        g2 = o.G2.from_affine(o.G2_GEN)
        return cls(
            scale=scale, machines_scale=machines_scale,
            g1_x=all_points[:t],
            worker_bases=all_points[t:t + m * t].view(m, t, 3, FQ.L),
            lagrange_y=all_points[t + m * t:],
            g2_gen=g2, g2_tau_x=o.G2.mul(g2, tau_x),
            g2_tau_y=o.G2.mul(g2, tau_y))

    @classmethod
    def generate_to_disk(cls, scale: int, machines_scale: int,
                         setup_path: str, precompute_path: str,
                         tau_x: Optional[int] = None,
                         tau_y: Optional[int] = None,
                         seed: int = 0, progress=None, device=None) -> None:
        """Stream-generate straight into the ``save()`` format.

        Worker slices go row by row into the sidecar memmap, so neither the
        device nor the host holds more than one worker's row of points at a
        time. ``progress`` (optional): callback(done_rows, total_rows) after
        each worker slice.
        """
        device = entry_device(device)
        tau_x, tau_y = _trapdoor(tau_x, tau_y, seed)
        m = 1 << machines_scale
        t = 1 << (scale - machines_scale)

        pow_x = FR.powers(FR.encode([tau_x], device)[0], t)
        lag_mont = FR.encode(_lagrange_coeffs_at(tau_y, m), device)

        def fixed_base_mont(mont_scalars):
            return to_numpy_points(
                _fixed_base_chunked(FR.from_mont(mont_scalars)))

        g2 = o.G2.from_affine(o.G2_GEN)
        np.savez_compressed(
            setup_path, version=FORMAT_VERSION, scale=scale,
            machines_scale=machines_scale, g1_x=fixed_base_mont(pow_x),
            g2_gen=_g2_bytes(g2), g2_tau_x=_g2_bytes(o.G2.mul(g2, tau_x)),
            g2_tau_y=_g2_bytes(o.G2.mul(g2, tau_y)))
        np.savez_compressed(
            precompute_path, sidecar=1, version=FORMAT_VERSION, scale=scale,
            machines_scale=machines_scale,
            lagrange_y=fixed_base_mont(lag_mont))
        side = np.lib.format.open_memmap(
            cls._sidecar_path(precompute_path), mode="w+",
            dtype=np.uint32, shape=(m, t, 3, FQ.L16))
        for i in range(m):
            side[i] = fixed_base_mont(FR.mont_mul(pow_x, lag_mont[i]))
            if progress is not None:
                progress(i + 1, m)
        side.flush()

    # -- persistence ---------------------------------------------------------

    #: above this many coefficients, worker_bases goes to a sidecar .npy
    #: written worker by worker through a memmap (and loadable lazily)
    _SIDE_CAR_LIMIT = 1 << 18

    def save(self, setup_path: str, precompute_path: str) -> None:
        """Write setup (G1/G2 powers) and precompute (worker slices) files.

        Small scales: everything inside the two .npz files. Large scales:
        worker_bases streams to ``<precompute>.bases.npy`` one worker slice
        at a time.
        """
        np.savez_compressed(
            setup_path, version=FORMAT_VERSION, scale=self.scale,
            machines_scale=self.machines_scale,
            g1_x=to_numpy_points(self.g1_x),
            g2_gen=_g2_bytes(self.g2_gen),
            g2_tau_x=_g2_bytes(self.g2_tau_x),
            g2_tau_y=_g2_bytes(self.g2_tau_y))
        m, t = self.machines, self.row_size
        meta = dict(version=FORMAT_VERSION, scale=self.scale,
                    machines_scale=self.machines_scale,
                    lagrange_y=to_numpy_points(self.lagrange_y))

        def host_row(i):
            row = self.worker_bases[i]
            return (to_numpy_points(row) if isinstance(row, torch.Tensor)
                    else np.asarray(row))

        if m * t <= self._SIDE_CAR_LIMIT:
            np.savez_compressed(
                precompute_path,
                worker_bases=np.stack([host_row(i) for i in range(m)]),
                **meta)
            return
        np.savez_compressed(precompute_path, sidecar=1, **meta)
        side = np.lib.format.open_memmap(
            self._sidecar_path(precompute_path), mode="w+",
            dtype=np.uint32, shape=(m, t, 3, FQ.L16))
        for i in range(m):
            side[i] = host_row(i)
        side.flush()

    @staticmethod
    def _sidecar_path(precompute_path: str) -> str:
        return precompute_path + ".bases.npy"

    @classmethod
    def load(cls, setup_path: str, precompute_path: str, lazy: bool = False,
             device=None) -> "Srs":
        """Load an SRS pair onto ``device``. ``lazy=True`` keeps a sidecar
        worker_bases as a read-only host memmap: slices reach the device on
        first use, through ``device_worker_bases``."""
        device = entry_device(device)
        for path in (setup_path, precompute_path):
            if not os.path.exists(path):
                raise FileNotFoundError(path)
        with np.load(setup_path) as s, np.load(precompute_path) as p:
            if int(s["version"]) != FORMAT_VERSION:
                raise ValueError("unsupported setup format")
            if int(s["scale"]) != int(p["scale"]) or \
                    int(s["machines_scale"]) != int(p["machines_scale"]):
                raise ValueError("setup/precompute mismatch")
            if "worker_bases" in p.files:
                bases = from_numpy_points(p["worker_bases"], device)
            else:
                bases = np.load(cls._sidecar_path(precompute_path),
                                mmap_mode="r")
                if not lazy:
                    bases = from_numpy_points(bases, device)
            return cls(
                scale=int(s["scale"]),
                machines_scale=int(s["machines_scale"]),
                g1_x=from_numpy_points(s["g1_x"], device),
                worker_bases=bases,
                lagrange_y=from_numpy_points(p["lagrange_y"], device),
                g2_gen=enc.g2_from_bytes(s["g2_gen"].tobytes()),
                g2_tau_x=enc.g2_from_bytes(s["g2_tau_x"].tobytes()),
                g2_tau_y=enc.g2_from_bytes(s["g2_tau_y"].tobytes()),
            )


def default_paths(base_dir: str, scale: int, machines_scale: int):
    """``setup_{scale}_{machines}`` naming parity (reference: Makefile:40-48)."""
    return (os.path.join(base_dir, f"setup_{scale}_{machines_scale}.npz"),
            os.path.join(base_dir, f"precompute_{scale}_{machines_scale}.npz"))
