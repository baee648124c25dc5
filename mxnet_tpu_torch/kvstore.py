"""KVStore: key-value synchronisation of parameters (reference:
mxnet_tpu/kvstore.py; its API: create, init, push, pull, set_optimizer,
rank, num_workers, barrier).

- ``local``, ``device`` (and the ``local_allreduce_*`` names): one process.
  A pushed list of shards is summed on the first shard's device, then the
  updater runs on the stored value, or without one the sum is stored.
- ``dist_sync`` (``dist_sync_device``, ``dist_tpu``, ``dist``): after the
  local sum, one ``torch.distributed.all_reduce`` a key across the workers
  (NCCL on the card, gloo on the CPU: :mod:`~mxnet_tpu_torch.distributed`),
  then every worker runs the same update on its copy. ``init`` broadcasts
  rank 0's value.
- ``dist_async`` (``dist_async_device``): the update runs at once on the
  local sum, with no wait for other workers (they may push unevenly);
  :meth:`KVStore.sync_weights`, called by every worker at aligned points of
  its loop (``fit`` calls it at each epoch's end and every
  ``MXTPU_ASYNC_SYNC_INTERVAL`` batches when set), averages every key's
  value across the workers. Its collectives pair by call order.

A distributed store joins the job's process group on creation
(:func:`~mxnet_tpu_torch.distributed.init`, a no-op without a coordinator
in the environment); with no group it is a one-process store of rank 0 of
1. A store pushes each key in its own collective, as the reference does.
"""
from __future__ import annotations

import os
import pickle

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device", "local_allreduce_cpu", "local_allreduce_device",
          "dist_sync", "dist_async", "dist_sync_device", "dist_async_device",
          "dist_tpu", "dist")


class KVStore:
    """Reference: mxnet_tpu/kvstore.py ``KVStore``."""

    def __init__(self, kind="local"):
        self.type = kind
        self._store: dict = {}
        self._updater = None
        self._optimizer = None
        self._is_dist = kind.startswith("dist")
        self._is_async = "async" in kind
        # dist_async: also average the weights every N batches (0: only at
        # each epoch's end). Safe only when every worker runs as many
        # batches an epoch: the collectives pair by call order
        self.sync_interval = int(os.environ.get(
            "MXTPU_ASYNC_SYNC_INTERVAL", "0"))
        if self._is_dist:
            from . import distributed

            distributed.init()

    # -- identity ----------------------------------------------------------------
    @property
    def rank(self) -> int:
        from . import distributed

        return distributed.rank() if self._is_dist else 0

    @property
    def num_workers(self) -> int:
        from . import distributed

        return distributed.size() if self._is_dist else 1

    def _dist_active(self) -> bool:
        """A process group is up (at any world size, so a one-card run
        still goes through the collective)."""
        if not self._is_dist:
            return False
        import torch.distributed as dist

        return dist.is_initialized()

    # -- core ops ----------------------------------------------------------------
    @staticmethod
    def _key_list(key, value):
        if isinstance(key, (int, str)):
            return [key], [value]
        assert len(key) == len(value)
        return list(key), list(value)

    def init(self, key, value):
        """Initialise each key once (a second init of a key does nothing);
        distributed, every worker stores rank 0's value."""
        keys, values = self._key_list(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            if isinstance(v, (list, tuple)):
                v = v[0]
            stored = v.copy()
            if self._dist_active():
                import torch.distributed as dist

                dist.broadcast(stored.data, src=0)
            self._store[k] = stored

    def push(self, key, value, priority=0):
        """Push each key's value, or list of shards (summed on the first
        shard's device); then, distributed and synchronous, all-reduce the
        sum across the workers; then update the stored value (the updater,
        else the sum replaces it)."""
        keys, values = self._key_list(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"kvstore: key {k} not initialized")
            # a list of several shards sums into a new tensor; one array is
            # the caller's, copied before anything writes it
            owned = isinstance(v, (list, tuple)) and len(v) > 1
            if isinstance(v, (list, tuple)):
                merged = v[0].data
                for shard in v[1:]:
                    merged = merged + shard.data.to(merged.device)
            else:
                merged = v.data
            stored = self._store[k]
            if self._dist_active() and not self._is_async:
                import torch.distributed as dist

                if not owned:
                    merged, owned = merged.clone(), True
                dist.all_reduce(merged)
            if merged.device != stored.data.device:
                merged, owned = merged.to(stored.data.device), True
            if self._updater is not None:
                self._updater(_key_int(k), NDArray(merged), stored)
            else:
                stored._data = merged if owned else merged.clone()

    def sync_weights(self):
        """dist_async's drift bound: average every key's value across the
        workers, in key order. Each worker calls it at the same points of
        its loop; nothing for other stores."""
        if not (self._dist_active() and self._is_async):
            return
        import torch.distributed as dist

        n = self.num_workers
        for k in sorted(self._store, key=str):
            cur = self._store[k]
            total = cur.data.clone()
            dist.all_reduce(total)
            cur._data = (total / n).to(cur.dtype)

    def pull(self, key, out=None, priority=0):
        """Copy each key's value into its output array, or each of a list
        of them (in place where shape and dtype agree)."""
        assert out is not None
        keys, outs = self._key_list(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"kvstore: key {k} not initialized")
            src = self._store[k]
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                _copy_into(src, dst)

    # -- optimizer ---------------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on every push through its updater; distributed
        over several workers each takes it by value, as the reference ships
        it pickled to its servers."""
        if self._is_dist and self.num_workers > 1:
            optimizer = pickle.loads(pickle.dumps(optimizer))
        self._optimizer = optimizer
        from .optimizer import get_updater

        self._set_updater(get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    def _barrier(self):
        if self._is_dist:
            from . import distributed

            distributed.barrier()

    def save_optimizer_states(self, fname):
        """Write the updater's states (this package's ``.states`` pickle),
        to a temporary name renamed into place."""
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        tmp = fname + ".tmp"
        with open(tmp, "wb") as fout:
            fout.write(self._updater.get_states())
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as fin:
            raw = fin.read()
        try:
            self._updater.set_states(raw)
        except Exception as e:
            from .model import CheckpointCorrupt

            raise CheckpointCorrupt(fname, f"optimizer states: {e}") from e


def _copy_into(src, dst):
    if dst.shape == src.shape and dst.dtype == src.dtype:
        dst._check_writable("copy into")
        dst.data.copy_(src.data)
    else:
        src.copyto(dst)


def _key_int(k):
    if isinstance(k, int):
        return k
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def create(name="local") -> KVStore:
    """A store of one of the reference's ten types (reference:
    src/kvstore/kvstore.cc's type strings)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _TYPES:
        raise MXNetError(f"unknown kvstore type {name!r} (valid: {_TYPES})")
    return KVStore(name)
