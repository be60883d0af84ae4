"""The comparison that decides ``correct``: every rank's outputs against the
plain reference (``reference.py``), each check a count of outputs that
differ, each held to the limit 0 (the comparison is exact).

- ``srs``: the sampled SRS points set-up derived (g1_x, worker bases,
  Lagrange-Y keys) that the rounds read;
- ``coeffs``: rows of the sampled rounds whose inverse NTT, read as a
  polynomial at the seed's point z, is not the row's f_i(z) (a wrong
  coefficient passes with probability below T / r);
- ``commitments``, ``evals``, ``openings``: rows of the sampled rounds;
- ``aggregate``: rounds (on any rank) whose C, W, C_y, W_y or value of a
  challenge is not the reference's.

A rank's observations hold, for each of its rounds and each of the
challenges it proves in a round (``members``), the aggregated proof, and
for the sampled rounds its rows' outputs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import reference as ref

CHECKS = ("srs", "coeffs", "commitments", "evals", "openings", "aggregate")
LIMITS = {name: 0 for name in CHECKS}
SRS_KINDS = ("g1_x", "bases", "lagrange_y")


def judge(obs: List[dict], expected: Dict[Tuple[int, int], ref.Expected],
          reference: ref.Reference) -> Tuple[Dict[str, int],
                                             Dict[str, int], int]:
    """(mismatches by check, outputs compared by check, rounds failed).
    ``obs``: every rank's observations (``Rank.observe``); ``expected``:
    the reference of every challenge the rounds proved, by (pool entry,
    challenge)."""
    bad = {name: 0 for name in CHECKS}
    seen = {name: 0 for name in CHECKS}
    comb = reference.comb
    agg_points = {c: [comb.mul(s) for s in e.aggregate]
                  for c, e in expected.items()}
    failed = set()
    for o in obs:
        for kind in SRS_KINDS:
            idx = o[f"srs_{kind}_idx"]
            pts = o[f"srs_{kind}"]
            scalars = [reference.srs_scalar(kind, i) for i in idx]
            bad["srs"] += ref.mismatches(pts, scalars, comb)
            seen["srs"] += len(scalars)
        lo = int(o["row_lo"])
        members = [int(g) for g in o["members"]]
        ml = o["com"].shape[2]
        rows = range(lo, lo + ml)
        for s, k in enumerate(o["sampled"]):
            for j, g in enumerate(members):
                e = expected[int(o["challenge"][k]), g]
                at_z = [v * ref.FR_MONT_INV % ref.R
                        for v in ref.combine(o["coeff_dot"][s, j])]
                bad["coeffs"] += sum(a != e.at_z[i]
                                     for a, i in zip(at_z, rows))
                bad["commitments"] += ref.mismatches(
                    o["com"][s, j], [e.commitments[i] for i in rows], comb)
                bad["evals"] += sum(a != e.evals[i] for a, i in
                                    zip(ref.fr_values(o["eval"][s, j]),
                                        rows))
                bad["openings"] += ref.mismatches(
                    o["proof"][s, j], [e.openings[i] for i in rows], comb)
                for name in ("coeffs", "commitments", "evals", "openings"):
                    seen[name] += ml
        values = ref.fr_values(o["value"])
        for k, c in enumerate(o["challenge"]):
            for j, g in enumerate(members):
                key = int(c), g
                wrong = (values[k * len(members) + j] != expected[key].value
                         or not all(ref.point_matches(p, q) for p, q in
                                    zip(o["agg"][k, j], agg_points[key])))
                if wrong:
                    failed.add(k)
                seen["aggregate"] += 1
    bad["aggregate"] = len(failed)
    return bad, seen, len(failed)


def correct(bad: Dict[str, int]) -> bool:
    return all(bad[name] <= LIMITS[name] for name in CHECKS)


def lines(bad: Dict[str, int], seen: Dict[str, int]) -> List[str]:
    return [f"check {name}: {bad[name]} of {seen[name]} differ "
            f"(limit {LIMITS[name]})" for name in CHECKS]


def as_result(bad: Dict[str, int]) -> dict:
    return {name: {"value": bad[name], "limit": LIMITS[name]}
            for name in CHECKS}


def empty_rows(ml: int, bl: int) -> dict:
    """Observations of no sampled round, for a rank of ``bl`` challenges a
    round whose window ended before any."""
    return {"sampled": np.zeros(0, np.int64),
            "com": np.zeros((0, bl, ml, 3, ref.FQ_WORDS), np.int32),
            "eval": np.zeros((0, bl, ml, ref.FR_WORDS), np.int32),
            "proof": np.zeros((0, bl, ml, 3, ref.FQ_WORDS), np.int32),
            "coeff_dot": np.zeros((0, bl, ml, 31), np.int64)}
