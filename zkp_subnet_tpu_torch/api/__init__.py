"""Client-facing API (the clean version of the reference's api/ intent).

Port of ``zkp_subnet_tpu/api/``."""

from .client import SubnetClient, get_query_uids, ping_uids

__all__ = ["SubnetClient", "get_query_uids", "ping_uids"]
