"""The one generator of the benchmark's traffic: challenges of the Pianist
prove round, drawn from the seed, as a traffic file's parameters say.

A traffic file (``benchmark/traffic/<name>.json``) holds:

- ``pool``: distinct challenges, cycled through the window in order
  (round k proves challenge k mod pool);
- ``ranks``: processes, one a card, that prove each round together;
- ``sampled_rounds``: rounds, drawn from the seed among the first
  ``pool``, whose every row is compared with the reference (every round's
  aggregated proof is compared);
- ``srs_samples``: how many SRS points of each kind are compared;
- ``challenges_per_round`` (default 1): challenges proved in one round,
  all opened at the round's one alpha, each with a beta of its own (the
  prove's batch);
- ``batch_ranks`` (default 1): the mesh's batch axis, rows of ranks that
  each prove their share of a round's challenges (``ranks`` is
  ``batch_ranks`` times the ranks of the machines axis);
- ``transforms`` (default ``["x"]``): the inverse NTTs run on the
  evaluations before the prove, ``"x"`` within each row, ``"y"`` across
  the M workers, each at most once.

A challenge is M rows of T evaluations and a beta, and a round's
challenges share an alpha: uniform elements of Fr, drawn on the device.
Every row has a seed of its own, made from the run's seed, the pool entry,
the challenge within it and the row, so a rank draws its own block and the
reference draws any row again, whatever the number of ranks.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference import FR_WORDS, R

#: r's 32-bit words, least significant first
_R_WORDS = [(R >> (32 * k)) & 0xFFFFFFFF for k in range(FR_WORDS)]


def mix(*parts) -> int:
    """A 63-bit seed from the run's seed and a tag: any integer seed."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def uniform_words(seeds: List[int], n: int, device) -> torch.Tensor:
    """(len(seeds), n, 8) int32: n uniform Fr elements a seed, as the words
    of their Montgomery form. A uniform word vector below r is the
    Montgomery form of a uniform element, so the words are drawn below
    2^255 and the first n below r of n + max(n, 64) draws are kept (r is
    0.9 of 2^255: fewer than n below r never happens in practice, and
    raises)."""
    b = len(seeds)
    cand = torch.empty((b, n + max(n, 64), FR_WORDS), dtype=torch.int64,
                       device=device)
    gen = torch.Generator(device=device)
    for i, seed in enumerate(seeds):
        gen.manual_seed(seed)
        cand[i].random_(0, 1 << 32, generator=gen)
    cand[..., FR_WORDS - 1] &= 0x7FFFFFFF
    below = torch.zeros(cand.shape[:2], dtype=torch.bool, device=device)
    equal = torch.ones_like(below)
    for k in range(FR_WORDS - 1, -1, -1):
        below |= equal & (cand[..., k] < _R_WORDS[k])
        equal &= cand[..., k] == _R_WORDS[k]
    pos = below.cumsum(1) - 1
    if bool((pos[:, -1] < n - 1).any()):
        raise RuntimeError("too few draws fell below r")
    slot = torch.where(below & (pos < n), pos, torch.full_like(pos, n))
    out = torch.zeros((b, n + 1, FR_WORDS), dtype=torch.int64,
                      device=device)
    out.scatter_(1, slot[..., None].expand_as(cand), cand)
    words = out[:, :n]
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


class Traffic:
    """A traffic file's parameters for one configuration and seed."""

    def __init__(self, params: dict, config: dict, seed: int):
        self.params = params
        self.seed = int(seed)
        self.workers = 1 << config["machines_scale"]
        self.row = 1 << (config["scale"] - config["machines_scale"])
        self.pool = int(params["pool"])
        self.ranks = int(params.get("ranks", 1))
        self.batch = int(params.get("challenges_per_round", 1))
        self.batch_ranks = int(params.get("batch_ranks", 1))
        self.transforms = list(params.get("transforms", ["x"]))
        if (self.ranks % self.batch_ranks
                or self.batch % self.batch_ranks):
            raise ValueError(f"{self.batch_ranks} batch ranks split neither "
                             f"{self.ranks} ranks or {self.batch} "
                             "challenges")
        if (not set(self.transforms) <= {"x", "y"}
                or len(set(self.transforms)) != len(self.transforms)):
            raise ValueError(f"transforms {self.transforms}: each of "
                             "'x', 'y' at most once")

    @property
    def machine_ranks(self) -> int:
        """Ranks on the mesh's machines axis."""
        return self.ranks // self.batch_ranks

    @property
    def rank_batch(self) -> int:
        """Challenges a rank proves in a round."""
        return self.batch // self.batch_ranks

    @property
    def rows_per_round(self) -> int:
        return self.batch * self.workers

    def trapdoor(self) -> Tuple[int, int]:
        rnd = random.Random(mix(self.seed, "trapdoor"))
        return rnd.randrange(1, R), rnd.randrange(1, R)

    def z(self) -> int:
        """The point at which the program's coefficients are read."""
        return random.Random(mix(self.seed, "z")).randrange(R)

    def challenge_of(self, k: int) -> int:
        return k % self.pool

    def sampled_rounds(self) -> List[int]:
        rnd = random.Random(mix(self.seed, "sampled_rounds"))
        n = min(int(self.params["sampled_rounds"]), self.pool)
        return sorted(rnd.sample(range(self.pool), n))

    def srs_indices(self) -> Dict[str, np.ndarray]:
        """Indices of the SRS points compared, kind by kind, uniform:
        ``g1_x`` (j,), ``bases`` (worker i, j), ``lagrange_y`` (i,); an
        (n, axes) int64 array each."""
        ranges = {"g1_x": (self.row,), "bases": (self.workers, self.row),
                  "lagrange_y": (self.workers,)}
        rnd = random.Random(mix(self.seed, "srs"))
        want = self.params["srs_samples"]
        return {kind: np.array([[rnd.randrange(b) for b in ranges[kind]]
                                for _ in range(int(want[kind]))],
                               np.int64).reshape(-1, len(ranges[kind]))
                for kind in sorted(want)}

    def rows(self, c: int, lo: int, hi: int, device, g: int = 0
             ) -> torch.Tensor:
        """Rows [lo, hi) of the evaluations of challenge g of pool entry
        c: (hi - lo, T, 8) words. c = -1 is the warm-up's entry, outside
        the pool."""
        tag = (c,) if g == 0 else (c, g)
        return uniform_words([mix(self.seed, "row", *tag, i)
                              for i in range(lo, hi)], self.row, device)

    def point(self, c: int, name: str, device, g: int = 0) -> torch.Tensor:
        """Pool entry c's ``alpha``, or its challenge g's ``beta``: (8,)
        words."""
        tag = (c,) if g == 0 else (c, g)
        return uniform_words([mix(self.seed, name, *tag)], 1, device)[0, 0]
