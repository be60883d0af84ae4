"""The card's peaks and the bound arithmetic of a roofline share.

A frozen copy of ``chip_smoke.py``'s (``HBM_BYTES_PER_S``,
``INT32_LANES_PER_SM``, ``OPS_*``, ``bound``), so that a later change to
the program's tools moves no yardstick. The memory rate is NVIDIA's data
sheet's for the H100 SXM; the integer rate is derived, not published: 64
INT32 lanes a streaming multiprocessor (Hopper architecture white paper) x
the card's SM count x its top SM clock as nvidia-smi reports it in the run,
one 32 x 32 -> 64-bit multiply-add counted as one lane-operation.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64

# 32-bit integer operations that each function needs: a CIOS product of L
# limbs is 2 L L multiply-adds; an add or subtract a carry chain and a
# conditional correction, 2 L. A point add (RCB15, a = 0) is 12 Fq
# products and 27 add/subtracts, the product by b3 = 12 counted as 4
# additions; a double 6 products, 2 squares (L (L + 1) / 2 limb products
# and the reduction's L L) and 13 add/subtracts.
OPS_FR_MUL, OPS_FR_LIN = 2 * 8 * 8, 2 * 8
OPS_FQ_MUL, OPS_FQ_LIN = 2 * 12 * 12, 2 * 12
OPS_FQ_SQR = 12 * 13 // 2 + 12 * 12
OPS_G1_ADD = 12 * OPS_FQ_MUL + 27 * OPS_FQ_LIN
OPS_G1_DOUBLE = 6 * OPS_FQ_MUL + 2 * OPS_FQ_SQR + 13 * OPS_FQ_LIN
G1_BYTES, FR_BYTES = 144, 32


def nvidia_smi(query: str) -> Optional[str]:
    """One value of the first card from nvidia-smi, or None without it."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (subprocess.SubprocessError, OSError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def _number(text: Optional[str]) -> Optional[float]:
    try:
        return float(text.split()[0]) if text else None
    except ValueError:
        return None


def card(sm_count: int) -> dict:
    """The card's SM count, top SM clock (MHz), power limit (W) and the
    integer rate they give (operations/s; None without a clock)."""
    mhz = _number(nvidia_smi("clocks.max.sm"))
    return {"sm_count": sm_count, "sm_clock_max_mhz": mhz,
            "power_limit_w": _number(nvidia_smi("power.limit")),
            "int_ops_per_s": (INT32_LANES_PER_SM * sm_count * mhz * 1e6
                              if mhz else None)}


def bound_s(nbytes: float, ops: float, int_ops_per_s: float) -> float:
    """The least time the work can take: the larger of bytes over the
    memory rate and integer operations over the integer rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / int_ops_per_s)
