"""KVBlockPool: the paged KV allocator (reference:
mxnet_tpu/serving/kvpool.py).

* One pool a lane: every per-layer cache name has one tensor
  ``(num_blocks, block_tokens, hidden)``, and one block id indexes the same
  physical slot in all of them. Ids 0 and 1 are reserved:
  ``KV_NULL_BLOCK`` (always zero, the gather target of unmapped table
  entries) and ``KV_TRASH_BLOCK`` (where masked writes land).
* Refcounted copy-on-write: a prefix hit maps shared blocks into a table
  with :meth:`incref`; before a step writes a block the session calls
  :meth:`cow` unless its refcount is 1, and :meth:`assert_owned` holds the
  decode op's contract that no two tables write one block.
* Zero-fill on free: a freed block is queued dirty and scrubbed to zero
  before it is handed out again (under ``MXNET_NAN_WATCHDOG`` it rests as
  NaN while free and is zeroed at allocation).
* A host tier: blocks page to host numpy by id and back, bit for bit.

Every device mutation (scrub, copy, upload, reset) writes the pool tensors
in place, so the executors bound over them, and a graph captured over them,
keep reading the same memory. The lock guards only the host-side
bookkeeping; device work runs on the session's worker thread.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import env
from ..base import MXNetError
from ..ops.attention import (KV_NULL_BLOCK, KV_RESERVED_BLOCKS,
                             KV_TRASH_BLOCK)
from .errors import KVPoolExhausted

__all__ = ["KVBlockPool", "KV_NULL_BLOCK", "KV_TRASH_BLOCK",
           "KV_RESERVED_BLOCKS"]


class KVBlockPool:
    """Fixed-size KV block allocator for one decode lane.

    Parameters
    ----------
    cache_names : list[str]
        The lane's per-layer cache names; one block id spans one physical
        slot in every name's tensor.
    block_tokens : int
        Tokens a block.
    hidden : int
        Row width.
    num_blocks : int
        Physical blocks including the two reserved ids.
    max_len : int
        The lane's context window: the block table is
        ``ceil(max_len / block_tokens)`` wide.
    ctx : Context
        Where the pool tensors live.
    """

    def __init__(self, cache_names, block_tokens, hidden, num_blocks,
                 max_len, ctx, name="kvpool"):
        from .. import ndarray as nd

        self.name = str(name)
        self.cache_names = list(cache_names)
        self.block_tokens = int(block_tokens)
        self.hidden = int(hidden)
        self.num_blocks = int(num_blocks)
        self.max_len = int(max_len)
        self.table_width = -(-self.max_len // self.block_tokens)
        if self.num_blocks < KV_RESERVED_BLOCKS + self.table_width:
            raise MXNetError(
                f"KVBlockPool: {self.num_blocks} blocks cannot hold one "
                f"max_len={self.max_len} sequence "
                f"({self.table_width} blocks) plus the "
                f"{KV_RESERVED_BLOCKS} reserved ids — raise "
                "MXNET_SERVING_KV_POOL_MB or shrink MXNET_SERVING_KV_BLOCK")
        self._ctx = ctx
        self.pools = {n: nd.zeros((self.num_blocks, self.block_tokens,
                                   self.hidden), ctx)
                      for n in self.cache_names}
        self.block_nbytes = (len(self.cache_names) * self.block_tokens
                             * self.hidden * 4)
        self._poison = env.get_bool("MXNET_NAN_WATCHDOG", False)
        self._lock = threading.Lock()
        self._refs = np.zeros((self.num_blocks,), np.int64)
        # LIFO free list, lowest id first out
        self._free = list(range(self.num_blocks - 1,
                                KV_RESERVED_BLOCKS - 1, -1))
        self._dirty: list = []     # freed, awaiting the worker's scrub
        self._host: dict = {}      # handle -> {name: np (n, bt, hidden)}
        self._host_bytes = 0
        self._next_handle = 0
        self.allocs = 0
        self.frees = 0
        self.shares = 0
        self.cow_copies = 0
        self.scrubs = 0
        self.poisons = 0
        self.page_outs = 0
        self.page_ins = 0
        self.alloc_fails = 0

    # -- capacity ---------------------------------------------------------------
    def capacity(self):
        """Allocatable blocks (the reserved ids excluded)."""
        return self.num_blocks - KV_RESERVED_BLOCKS

    def available(self):
        """Blocks an :meth:`alloc` could hand out now: the free list plus
        the dirty queue (scrubbed before allocating)."""
        with self._lock:
            return len(self._free) + len(self._dirty)

    def refcount(self, bid):
        with self._lock:
            return int(self._refs[bid])

    def blocks_for_tokens(self, tokens):
        """ceil(tokens / block_tokens)."""
        return -(-int(tokens) // self.block_tokens)

    # -- allocation ---------------------------------------------------------------
    def alloc(self, n):
        """``n`` fresh blocks (refcount 1 each), after scrubbing the dirty
        queue; all or nothing. Raises :class:`KVPoolExhausted` when the
        pool cannot grant them. Worker thread only (device work)."""
        n = int(n)
        if n <= 0:
            return []
        self.scrub_dirty()
        with self._lock:
            if len(self._free) < n:
                self.alloc_fails += 1
                free = len(self._free)
                raise KVPoolExhausted(
                    f"kv pool {self.name!r}: need {n} block(s), "
                    f"{free} free of {self.capacity()} "
                    f"(block={self.block_tokens} tok); shed typed — "
                    "blocks free as resident sequences finish",
                    needed=n, free=free)
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            self.allocs += n
        if self._poison:
            self._fill(ids, 0.0)
            with self._lock:
                self.scrubs += 1
        return ids

    def incref(self, ids):
        """One more reference a block (prefix sharing). Any thread."""
        if not ids:
            return
        with self._lock:
            for b in ids:
                if self._refs[b] < 1:
                    raise MXNetError(
                        f"KVBlockPool.incref: block {b} is not live")
                self._refs[b] += 1
            self.shares += len(ids)

    def free(self, ids):
        """One reference less a block; a block at zero queues for the
        worker's scrub. Any thread (no device work)."""
        if not ids:
            return
        with self._lock:
            for b in ids:
                if b < KV_RESERVED_BLOCKS or self._refs[b] < 1:
                    raise MXNetError(
                        f"KVBlockPool.free: block {b} double-freed or "
                        "reserved")
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    self._dirty.append(b)
            self.frees += len(ids)

    def assert_owned(self, ids):
        """The decode op's contract: every block a step writes has exactly
        one reference, so no write lands in a block another table maps."""
        with self._lock:
            shared = [int(b) for b in ids if self._refs[b] != 1]
        if shared:
            raise MXNetError(f"KVBlockPool {self.name!r}: a step would "
                             f"write shared or dead blocks {shared}")

    def scrub_dirty(self):
        """Scrub the dirty queue onto the free list (zero, or NaN under the
        watchdog). Worker thread only. Returns the blocks scrubbed."""
        with self._lock:
            dirty, self._dirty = self._dirty, []
        if not dirty:
            return 0
        self._fill(dirty, float("nan") if self._poison else 0.0)
        with self._lock:
            self._free.extend(sorted(dirty, reverse=True))
            if self._poison:
                self.poisons += 1
            else:
                self.scrubs += 1
        return len(dirty)

    def cow(self, bid):
        """Copy-on-write: a private copy of shared block ``bid`` in every
        cache name; the caller's reference moves to the copy, whose id is
        returned. Worker thread only."""
        new = self.alloc(1)[0]
        src, dst = self._ids([bid]), self._ids([new])
        for name in self.cache_names:
            t = self.pools[name].data
            t.index_copy_(0, dst, t.index_select(0, src))
        self.free([bid])
        with self._lock:
            self.cow_copies += 1
        return new

    # -- host tier ------------------------------------------------------------------
    def to_host(self, ids):
        """Page blocks to the host tier: copy them to host numpy under a
        new handle and drop the caller's device references. Returns the
        handle for :meth:`from_host`."""
        ids = list(ids)
        host = self.read_blocks(ids)
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._host[handle] = host
            self._host_bytes += len(ids) * self.block_nbytes
            self.page_outs += len(ids)
        self.free(ids)
        return handle

    def from_host(self, handle, drop=True):
        """Upload a host-tier handle into fresh device blocks (refcount 1,
        the caller's); ``drop`` releases the host copy. Raises
        :class:`KVPoolExhausted` (keeping the host copy) when no blocks are
        free. Worker thread only."""
        with self._lock:
            host = self._host.get(handle)
            if host is None:
                raise MXNetError(f"KVBlockPool.from_host: unknown handle "
                                 f"{handle}")
        n = next(iter(host.values())).shape[0]
        ids = self.alloc(n)
        self.write_blocks(ids, host)
        with self._lock:
            self.page_ins += n
        if drop:
            self.drop_host(handle)
        return ids

    def drop_host(self, handle):
        """Release one host-tier handle."""
        with self._lock:
            host = self._host.pop(handle, None)
            if host is not None:
                n = next(iter(host.values())).shape[0]
                self._host_bytes -= n * self.block_nbytes

    def host_handles(self):
        with self._lock:
            return len(self._host)

    # -- device copies ------------------------------------------------------------
    def _ids(self, ids):
        import torch

        return torch.as_tensor(np.asarray(ids, np.int64),
                               device=self._ctx.torch_device)

    def read_blocks(self, ids):
        """{name: host numpy (len(ids), block_tokens, hidden)}."""
        idx = self._ids(ids)
        return {name: self.pools[name].data.index_select(0, idx)
                .cpu().numpy() for name in self.cache_names}

    def write_blocks(self, ids, host):
        """Upload host block contents into device blocks ``ids``, in place.
        Worker thread only."""
        import torch

        idx = self._ids(ids)
        for name in self.cache_names:
            t = self.pools[name].data
            vals = torch.from_numpy(np.ascontiguousarray(
                np.asarray(host[name], np.float32)[:len(ids)]))
            t.index_copy_(0, idx, vals.to(t.device))

    def _fill(self, ids, value):
        """Blocks to a constant (0.0 or NaN), in place. Worker only."""
        idx = self._ids(ids)
        for name in self.cache_names:
            self.pools[name].data.index_fill_(0, idx, value)

    # -- reset ------------------------------------------------------------------------
    def reset(self):
        """Zero the pools in place and forget every device block; the host
        tier stays. Worker thread only."""
        with self._lock:
            self._refs[:] = 0
            self._free = list(range(self.num_blocks - 1,
                                    KV_RESERVED_BLOCKS - 1, -1))
            self._dirty = []
        for name in self.cache_names:
            self.pools[name].data.zero_()

    def stats(self):
        with self._lock:
            free = len(self._free)
            dirty = len(self._dirty)
            return {
                "blocks": self.num_blocks,
                "block_tokens": self.block_tokens,
                "capacity": self.capacity(),
                "free": free,
                "dirty": dirty,
                "used": self.capacity() - free - dirty,
                "shared_blocks": int(np.sum(self._refs > 1)),
                "free_bytes": (free + dirty) * self.block_nbytes,
                "block_bytes": self.block_nbytes,
                "allocs": self.allocs,
                "frees": self.frees,
                "shares": self.shares,
                "cow_copies": self.cow_copies,
                "scrubs": self.scrubs,
                "poisons": self.poisons,
                "page_outs": self.page_outs,
                "page_ins": self.page_ins,
                "alloc_fails": self.alloc_fails,
                "host_handles": len(self._host),
                "host_bytes": self._host_bytes,
            }
