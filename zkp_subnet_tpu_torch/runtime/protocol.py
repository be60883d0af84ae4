"""Wire protocol: the ``Prove`` message.

The port's own copy of ``zkp_subnet_tpu/runtime/protocol.py``.

Field-for-field parity with the reference synapse (reference:
base/protocol.py:24-63): frozen ``index`` (worker identity) and ``poly``
(base64 scalars), mutable ``alpha``/``eval_``/``commitment``/``proof``.
Responses echo the index and strip ``poly`` to save bandwidth (reference:
neurons/miner.py:119-128). ``process_time`` carries the latency the
coordinator scores (the reference reads it off the dendrite response,
neurons/validator.py:152).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Prove:
    index: int                              # frozen: worker identity
    poly: List[str]                         # frozen: b64 coefficient row
    alpha: Optional[str] = None             # challenge point
    eval_: Optional[str] = None             # claimed f_i(alpha)
    commitment: Optional[str] = None        # b64 G1
    proof: Optional[str] = None             # b64 G1
    process_time: Optional[float] = None    # stamped by the transport
    status_code: int = 200

    def deserialize(self) -> "Prove":
        """Parity with reference protocol.py:62-63 (returns self)."""
        return self

    def response(self, eval_: Optional[str], commitment: Optional[str],
                 proof: Optional[str]) -> "Prove":
        """Build the stripped response (reference: neurons/miner.py:119-128)."""
        return Prove(index=self.index, poly=[], alpha=self.alpha,
                     eval_=eval_, commitment=commitment, proof=proof)
