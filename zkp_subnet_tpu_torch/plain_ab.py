"""The plain PyTorch versions of several checkouts of this repository, timed
in turns on this host's CPU at the sizes the CPU tests use.

Run from the root of a checkout, on any machine (no card needed):

    python -m zkp_subnet_tpu_torch.plain_ab DIR [DIR ...]

Each DIR is the root of a checkout (an earlier commit unpacked with
``git archive``, or a copy with one change). Each is driven through its own
package, in a process of its own, with one torch thread, as the
``tests/test_torch_*`` files run: ``fr_mul_plain`` and ``fq_mul_plain`` of
4096 elements, ``g1_add_plain`` of 1024 points, the ladder
``g1_scalar_mul_plain`` over 16 and 256 points, a Pippenger ``msm`` of 256
points and ``poly_open_scalars`` of a 16-coefficient row. Each figure is
the best of a few calls, in seconds. The inputs come from one seed; every
checkout's outputs must equal the first's limb for limb. Every checkout is
timed twice, in the order given and then in the reverse order. The last
line is one JSON object: {DIR: [figures of the first turn, of the second]}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 20261017


def child() -> dict:
    """Time the package this process imports (its checkout on PYTHONPATH)."""
    import hashlib
    import random

    import torch

    from zkp_subnet_tpu_torch.ops import curve as cv
    from zkp_subnet_tpu_torch.ops import field as f
    from zkp_subnet_tpu_torch.ops import msm as tmsm
    from zkp_subnet_tpu_torch.ops import poly as tpoly
    from zkp_subnet_tpu_torch.utils import oracle as o

    torch.set_num_threads(1)
    rnd = random.Random(SEED)
    g = o.G1.from_affine(o.G1_GEN)
    pts = cv.g1_encode([o.G1.mul(g, rnd.randrange(1, o.R))
                        for _ in range(1024)])
    scal = cv.fr_to_scalar_limbs([rnd.randrange(o.R) for _ in range(256)])
    fr = [f.FR.encode([rnd.randrange(o.R) for _ in range(4096)])
          for _ in range(2)]
    fq = [f.FQ.encode([rnd.randrange(o.Q) for _ in range(4096)])
          for _ in range(2)]
    row, x = f.FR.encode([rnd.randrange(o.R) for _ in range(17)]).split(16)
    cases = {
        "fr_mul 4096": (lambda: f.fr_mul_plain(*fr), 5),
        "fq_mul 4096": (lambda: f.fq_mul_plain(*fq), 5),
        "g1_add 1024": (lambda: cv.g1_add_plain(pts, pts.roll(1, 0)), 3),
        "ladder 16": (lambda: cv.g1_scalar_mul_plain(pts[:16], scal[:16]), 2),
        "ladder 256": (lambda: cv.g1_scalar_mul_plain(pts[:256], scal), 2),
        "msm 256": (lambda: tmsm.msm(pts[:256], scal), 2),
        "open_scalars 16": (lambda: tpoly.poly_open_scalars(row, x[0]), 3),
    }
    times, digest = {}, hashlib.sha256()
    for name, (fn, reps) in cases.items():
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        for t in out if isinstance(out, tuple) else (out,):
            digest.update(t.contiguous().numpy().tobytes())
        times[name] = best
    return {"times": times, "digest": digest.hexdigest()}


def _run(root: str) -> dict:
    """``child`` of this file, run against ``root``'s package."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child"], env=env, cwd=os.path.abspath(root),
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def main(argv=None) -> int:
    roots = list(sys.argv[1:] if argv is None else argv)
    if not roots:
        print(__doc__)
        return 2
    results = {r: [] for r in roots}
    digests = {}
    for order in (roots, roots[::-1]):
        for root in order:
            res = _run(root)
            digests.setdefault(root, res["digest"])
            results[root].append(res["times"])
            print(root, " ".join(f"{k}: {v:.4f}"
                                 for k, v in res["times"].items()), flush=True)
    ok = all(d == digests[roots[0]] for d in digests.values())
    print("outputs equal to the first checkout's:", ok)
    print(json.dumps(results))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        print(json.dumps(child()))
    else:
        sys.exit(main())
