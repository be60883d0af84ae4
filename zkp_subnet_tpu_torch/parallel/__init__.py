"""Multi-device sharding on torch.distributed: the (batch, machines) mesh
and the SPMD Pianist prove and NTT (``parallel/pianist.py``), the launcher
(``parallel/launch.py``) and a small dry run of both (``parallel/dryrun.py``).
"""

from .pianist import (BATCH_AXIS, MACHINES_AXIS, DistributedProof, fft,
                      make_mesh, prove, shard_srs)

__all__ = ["BATCH_AXIS", "MACHINES_AXIS", "DistributedProof", "fft",
           "make_mesh", "prove", "shard_srs"]
