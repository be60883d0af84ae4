"""The schedule of K2 ``msm_combine`` (``csrc/msm.cu``): which Fq operation
each lane of the warp does in each round of a point operation.

A point operation is a list of rounds; in a round each entry (dst, op, a, b)
is one Fq operation done by one lane, all entries side by side, and the
values pass through named slots. X1 Y1 Z1 is the accumulator (read, and
written by the last rounds), X2 Y2 Z2 the point added. The field values are
those of ``csrc/g1.cuh`` (RCB15 Algorithms 7 and 9, a = 0), with each
product by b3 = 12 as the add chain 2v, 4v, 8v, 8v + 4v: two rounds of
products a point operation.

There is one schedule. ``program`` assembles it into the table the kernel
reads; ``ops/kernels.py:msm_combine`` fetches it there, and the CPU tests run
the same table through ``ops/msm.py:run_rounds_plain``. The kernel's limits
(table words, slots) stand in ``csrc/msm.cu`` alone: the launch passes what
this table needs, and the C entry refuses a table that does not fit.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

Round = Sequence[Tuple[str, str, str, str]]

DOUBLE_ROUNDS: Tuple[Round, ...] = (
    (("t0", "mul", "Y1", "Y1"), ("tyz", "mul", "Y1", "Z1"),
     ("tzz", "mul", "Z1", "Z1"), ("txy", "mul", "X1", "Y1")),
    (("a2", "add", "t0", "t0"), ("c2", "add", "tzz", "tzz")),
    (("a4", "add", "a2", "a2"), ("c4", "add", "c2", "c2")),
    (("z8", "add", "a4", "a4"), ("c8", "add", "c4", "c4")),     # 8·Y²
    (("t2b", "add", "c8", "c4"),),                             # 3b·Z²
    (("y3a", "add", "t0", "t2b"), ("t1c", "add", "t2b", "t2b")),
    (("t2c", "add", "t1c", "t2b"),),                           # 9b·Z²
    (("t0b", "sub", "t0", "t2c"),),
    (("x3m", "mul", "t2b", "z8"), ("Z1", "mul", "tyz", "z8"),
     ("y3m", "mul", "t0b", "y3a"), ("x3o", "mul", "t0b", "txy")),
    (("Y1", "add", "x3m", "y3m"), ("X1", "add", "x3o", "x3o")),
)

ADD_ROUNDS: Tuple[Round, ...] = (
    (("a1", "add", "X1", "Y1"), ("a3", "add", "Y1", "Z1"),
     ("a5", "add", "X1", "Z1"), ("a2", "add", "X2", "Y2"),
     ("a4", "add", "Y2", "Z2"), ("a6", "add", "X2", "Z2")),
    (("t0", "mul", "X1", "X2"), ("t1", "mul", "Y1", "Y2"),
     ("t2", "mul", "Z1", "Z2"), ("p1", "mul", "a1", "a2"),
     ("p2", "mul", "a3", "a4"), ("p3", "mul", "a5", "a6")),
    (("s1", "add", "t0", "t1"), ("s2", "add", "t1", "t2"),
     ("s3", "add", "t0", "t2"), ("d0", "add", "t0", "t0"),
     ("c2", "add", "t2", "t2")),
    (("t3", "sub", "p1", "s1"),                    # X1·Y2 + X2·Y1
     ("t4", "sub", "p2", "s2"),                    # Y1·Z2 + Y2·Z1
     ("ty", "sub", "p3", "s3"),                    # X1·Z2 + X2·Z1
     ("t0t", "add", "d0", "t0"),                   # 3·X1·X2
     ("c4", "add", "c2", "c2")),
    (("e2", "add", "ty", "ty"), ("c8", "add", "c4", "c4")),
    (("e4", "add", "e2", "e2"), ("t2b", "add", "c8", "c4")),   # 3b·Z1·Z2
    (("e8", "add", "e4", "e4"), ("z3t", "add", "t1", "t2b"),
     ("t1t", "sub", "t1", "t2b")),
    (("y3b", "add", "e8", "e4"),),                 # 3b·(X1·Z2 + X2·Z1)
    (("w0", "mul", "t3", "t1t"), ("w1", "mul", "t4", "y3b"),
     ("w2", "mul", "y3b", "t0t"), ("w3", "mul", "t1t", "z3t"),
     ("w4", "mul", "z3t", "t4"), ("w5", "mul", "t0t", "t3")),
    (("X1", "sub", "w0", "w1"), ("Y1", "add", "w2", "w3"),
     ("Z1", "add", "w4", "w5")),
)

#: lanes of the warp that take an operation: the widest round above
LANES = max(len(entries) for entries in DOUBLE_ROUNDS + ADD_ROUNDS)

_POINT_SLOTS = ("X1", "Y1", "Z1", "X2", "Y2", "Z2")
_OP_CODES = {"mul": 1, "add": 2, "sub": 3}


def assemble(rounds: Sequence[Round]) -> List[List[int]]:
    """A table as the kernel reads it: one row of LANES words a round, a
    word being kind | a << 8 | b << 16 | dst << 24 (0: no operation). A
    value gets the next free slot where it is first written. No entry may
    read a slot that another entry of its round writes."""
    slot = {name: i for i, name in enumerate(_POINT_SLOTS)}
    table = []
    for entries in rounds:
        if len(entries) > LANES:
            raise ValueError("too many operations in a round")
        written = [dst for dst, *_ in entries]
        row = [0] * LANES
        for lane, (dst, op, a, b) in enumerate(entries):
            if {a, b} & (set(written) - {dst}) or written.count(dst) > 1:
                raise ValueError(f"round reads or rewrites {dst}, {a}, {b}")
            d = slot.setdefault(dst, len(slot))
            row[lane] = (_OP_CODES[op] | slot[a] << 8 | slot[b] << 16
                         | d << 24)
        table.append(row)
    return table


class Program(NamedTuple):
    table: torch.Tensor      #: (rounds, LANES) int32: the double, then the add
    double_rounds: int       #: rounds of the double; the rest are the add's
    slots: int               #: Fq slots the table addresses


_cache: Dict[str, Program] = {}


def program(device) -> Program:
    """The one schedule, assembled, with its table on ``device``."""
    key = str(device)
    if key not in _cache:
        double, add = assemble(DOUBLE_ROUNDS), assemble(ADD_ROUNDS)
        slots = 1 + max(w >> 24 for row in double + add for w in row)
        _cache[key] = Program(
            torch.tensor(double + add, dtype=torch.int32, device=device),
            len(double), slots)
    return _cache[key]
