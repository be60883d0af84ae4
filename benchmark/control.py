"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed with one of the
configuration's guarantees broken, has to come out as not correct.

The configurations state no precision; the guarantee broken is that every
element is a full 255-bit element of Fr. The control keeps 254 bits of each
stored element, as an implementation that stored Fr in 254 bits would: the
evaluations', alpha's and beta's Montgomery words, the trapdoor and the
SRS points' scalars lose their top bit. It then proves the cell's rounds
(every pool challenge once, the traffic's sampled rounds row by row) as
the reference's formulas give them, and hands its outputs to the judge in
the program's format:

    python benchmark/control.py --workload <cell> --seeds 11,12,13

prints, a seed a line, each check's count of outputs that differ. Run it
on the card at the cell's own size; ``tests/test_bench_control.py`` runs it
at a test's size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import judge as judge_mod  # noqa: E402
from benchmark import reference as ref  # noqa: E402
from benchmark.spec import Spec  # noqa: E402
from benchmark.traffic import Traffic  # noqa: E402

#: the bits the control keeps of every stored element
BITS = 254
_MASK = (1 << BITS) - 1


def _cut_words(words: torch.Tensor) -> torch.Tensor:
    """Montgomery words with bit 254 and above cleared."""
    out = words.clone()
    out[..., -1] &= (1 << (BITS - 7 * 32)) - 1
    return out


def _limb_sums(values) -> np.ndarray:
    """Fr values -> (N, 31) limb sums that ``reference.combine`` reads as
    their Montgomery words."""
    out = np.zeros((len(values), 31), np.int64)
    for i, v in enumerate(values):
        x = v * ref.FR_MONT % ref.R
        for t in range(31):
            out[i, t] = (x >> (16 * t)) & 0xFFFF
    return out


def _points(comb: ref.Comb, scalars) -> np.ndarray:
    return np.stack([ref.point_words(comb.mul(s)) for s in scalars]
                    ) if len(scalars) else np.zeros((0, 3, ref.FQ_WORDS),
                                                     np.int32)


def readings(spec: Spec, cell_name: str, seed: int, device) -> Dict[str,
                                                                     int]:
    """The judge's counts for the control of one seed."""
    cell = spec.cell(cell_name)
    tr = Traffic(spec.traffic(cell), spec.config(cell), seed)
    tau_x, tau_y = tr.trapdoor()
    z = tr.z()
    true_ref = ref.Reference(tau_x, tau_y, tr.workers, tr.row, z, device,
                             tr.transforms)
    ctl_ref = ref.Reference(tau_x & _MASK, tau_y & _MASK, tr.workers,
                            tr.row, z, device, tr.transforms)
    expected, ctl = {}, {}
    members = range(tr.batch)
    for c in range(tr.pool):
        for g in members:
            rows = tr.rows(c, 0, tr.workers, device, g)
            alpha = tr.point(c, "alpha", device)
            beta = tr.point(c, "beta", device, g)
            expected[c, g] = true_ref.challenge(
                rows, *(ref.fr_values(p.cpu().numpy()[None])[0]
                        for p in (alpha, beta)))
            ctl[c, g] = ctl_ref.challenge(
                _cut_words(rows), *(ref.fr_values(
                    _cut_words(p).cpu().numpy()[None])[0]
                    for p in (alpha, beta)))
    comb = ctl_ref.comb
    sampled = tr.sampled_rounds()

    def each(cs, fn):
        return np.stack([np.stack([fn(ctl[c, g]) for g in members])
                         for c in cs])
    obs = {"row_lo": np.int64(0),
           "members": np.arange(tr.batch, dtype=np.int64),
           "challenge": np.arange(tr.pool, dtype=np.int64),
           "value": each(range(tr.pool), lambda e: ref.fr_words([e.value])
                         [0]),
           "agg": each(range(tr.pool), lambda e: _points(comb, e.aggregate)),
           "sampled": np.array(sampled, np.int64),
           "com": each(sampled, lambda e: _points(comb, e.commitments)),
           "eval": each(sampled, lambda e: ref.fr_words(e.evals)),
           "proof": each(sampled, lambda e: _points(comb, e.openings)),
           "coeff_dot": each(sampled, lambda e: _limb_sums(e.at_z))}
    for kind, idx in tr.srs_indices().items():
        obs[f"srs_{kind}_idx"] = idx
        obs[f"srs_{kind}"] = _points(comb, [
            true_ref.srs_scalar(kind, i) & _MASK for i in idx])
    bad, _, _ = judge_mod.judge([obs], expected, true_ref)
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, a line each")
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    spec = Spec(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        bad = readings(spec, args.workload, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": bad,
                          "correct": judge_mod.correct(bad)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
