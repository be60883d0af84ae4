"""Runtime on torch tensors: the Pianist worker, the coordinator, and the
transports between them (in-process, over a torch.distributed mesh,
mocked, HTTP).

Port of ``zkp_subnet_tpu/runtime/``: everything its ``__init__`` exports.
"""

from .config import (CoordinatorConfig, ProverConfig, WorkerConfig,
                     add_coordinator_args, add_worker_args,
                     coordinator_config, worker_config)
from .coordinator import Challenge, Coordinator
from .protocol import Prove
from .server import HttpTransport, WorkerServer
from .transport import LocalTransport, MeshTransport, MockTransport
from .worker import Worker

__all__ = ["Challenge", "Coordinator", "CoordinatorConfig", "HttpTransport",
           "LocalTransport", "MeshTransport", "MockTransport", "Prove",
           "ProverConfig", "Worker", "WorkerConfig", "add_coordinator_args",
           "add_worker_args", "coordinator_config", "worker_config",
           "WorkerServer"]
