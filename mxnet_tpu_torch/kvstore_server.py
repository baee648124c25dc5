"""The server role of the distributed KVStore (reference:
mxnet_tpu/kvstore_server.py).

The port has no server processes: a distributed store's workers sum their
gradients with ``torch.distributed`` collectives (:mod:`~mxnet_tpu_torch.
kvstore`), so every process is a worker. The reference's process contract is
kept for launchers written for ps-lite: a process started with
``DMLC_ROLE=server`` or ``scheduler`` exits 0 at ``import mxnet_tpu_torch``
instead of waiting in a role that does not exist, and
``KVStoreServer(kv).run()`` returns at once. ``tools/launch.py`` starts
only workers.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """Reference: kvstore_server.py ``KVStoreServer``."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        """Return at once: the workers' collectives do the server's work."""
        logging.info("kvstore_server: no server role, the workers sum "
                     "their gradients with collectives; returning")


def _init_kvstore_server_module():
    """Exit 0 in a process launched as a server or scheduler (reference:
    kvstore_server.py, which serves, then exits)."""
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("server", "scheduler"):
        logging.info("kvstore_server: launched as %r, a role the port does "
                     "not have; exiting", role)
        sys.exit(0)


_init_kvstore_server_module()
