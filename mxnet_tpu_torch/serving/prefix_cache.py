"""PrefixKVCache: an LRU of decoded KV prefixes keyed by their tokens
(reference: mxnet_tpu/serving/prefix_cache.py).

* Dense entries hold each cache name's rows of the prefix, copied off the
  session's slot when a prompt's prefill completes and when a sequence
  finishes (the reference keeps zero-copy slices of immutable arrays; the
  port's caches are written in place, so an entry is a device copy of the
  prefix's rows). They stay on the device until the device tier passes its
  budget (``device_bytes``, default half the total), then the least
  recently used page to host numpy; fp32 round trips are bit-exact.
* Total bytes (device and host) are bounded by ``max_bytes``; least
  recently used entries are evicted past it.
* :meth:`lookup` finds the longest common prefix of a prompt with any
  entry, so a conversation that grew by a turn reuses all before it.
* Paged entries are refcounted block lists of a
  :class:`~mxnet_tpu_torch.serving.kvpool.KVBlockPool`: :meth:`put_blocks`
  parks a prefix by ``incref`` and :meth:`acquire_blocks` maps the shared
  blocks into a new table, with no device copy; cold entries demote their
  blocks to the pool's host tier (:meth:`relieve_blocks` picks victims by
  :func:`~mxnet_tpu_torch.serving.costs.eviction_score`), and a host hit
  uploads them back bit for bit.

No device work runs under the cache lock: a demotion claims an entry under
the lock (it goes ``pending``: invisible to lookups, owning nothing), copies
outside it and commits under it.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .costs import eviction_score
from .errors import KVPoolExhausted

__all__ = ["PrefixKVCache"]


def _nbytes(a):
    return int(np.prod(a.shape)) * (a.element_size()
                                    if hasattr(a, "element_size")
                                    else a.dtype.itemsize)


def _to_numpy(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


class _Entry:
    """One cached prefix: ``kind == "rows"`` holds per-name arrays (device
    tensors while hot, host numpy once paged out); ``kind == "blocks"`` a
    block-id list while on the device, a pool host-tier ``handle`` once
    demoted."""

    __slots__ = ("key", "length", "arrays", "nbytes", "on_device", "kind",
                 "blocks", "handle", "pool", "pending", "last_used")

    def __init__(self, key, length, arrays, nbytes, kind="rows",
                 blocks=None, pool=None):
        self.key = key
        self.length = length
        self.arrays = arrays
        self.nbytes = nbytes
        self.on_device = True
        self.kind = kind
        self.blocks = blocks
        self.handle = None
        self.pool = pool
        self.pending = False
        self.last_used = time.monotonic()


class PrefixKVCache:
    """Bounded LRU of KV prefixes (module docstring).

    Parameters
    ----------
    max_bytes : int
        Budget across the device and host tiers; 0 stores nothing.
    device_bytes : int, optional
        Device-tier budget (default half of ``max_bytes``).
    """

    def __init__(self, max_bytes, device_bytes=None):
        self.max_bytes = int(max_bytes)
        self.device_bytes_cap = (int(device_bytes) if device_bytes
                                 is not None else self.max_bytes // 2)
        self._lock = threading.Lock()
        self._entries = {}          # key tuple -> _Entry
        self._order = []            # LRU order, oldest first
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.page_outs = 0
        self.tokens_reused = 0
        self.block_puts = 0
        self.block_shares = 0
        self.block_promotes = 0
        self.block_demotions = 0

    # -- store ----------------------------------------------------------------
    def put(self, tokens, arrays):
        """Store the KV rows of the prefix ``tokens``: ``arrays`` maps cache
        name -> (>= len(tokens), hidden) array the cache may keep (rows past
        ``len(tokens)`` are ignored). Returns True when stored."""
        key = tuple(int(t) for t in tokens)
        if not key or self.max_bytes <= 0:
            return False
        nbytes = sum(_nbytes(a) for a in arrays.values())
        if nbytes > self.max_bytes:
            return False
        with self._lock:
            old = self._pop_locked(key)
            self._entries[key] = _Entry(key, len(key), dict(arrays), nbytes)
            self._order.append(key)
            self.bytes += nbytes
            evict, demote = self._rebalance_locked()
        self._apply_rebalance(old, evict, demote)
        return True

    def put_blocks(self, tokens, block_ids, pool):
        """Paged park: the prefix as a block list, one ``incref`` a block,
        no device copy. Returns True when stored."""
        key = tuple(int(t) for t in tokens)
        ids = list(block_ids)
        if not key or not ids or self.max_bytes <= 0:
            return False
        nbytes = len(ids) * pool.block_nbytes
        if nbytes > self.max_bytes:
            return False
        pool.incref(ids)
        with self._lock:
            old = self._pop_locked(key)
            self._entries[key] = _Entry(key, len(key), None, nbytes,
                                        kind="blocks", blocks=ids,
                                        pool=pool)
            self._order.append(key)
            self.bytes += nbytes
            self.block_puts += 1
            evict, demote = self._rebalance_locked()
        self._apply_rebalance(old, evict, demote)
        return True

    def _pop_locked(self, key):
        old = self._entries.pop(key, None)
        if old is not None:
            self._order.remove(key)
            self.bytes -= old.nbytes
        return old

    def _rebalance_locked(self):
        """Evict the least recent past the byte budget; pick device entries
        to demote while the device tier is over its budget."""
        evicted = []
        while self.bytes > self.max_bytes and self._order:
            key = self._order.pop(0)
            e = self._entries.pop(key)
            self.bytes -= e.nbytes
            self.evictions += 1
            evicted.append(e)
        demote = []
        dev = sum(e.nbytes for e in self._entries.values() if e.on_device)
        for k in self._order:
            if dev <= self.device_bytes_cap:
                break
            e = self._entries[k]
            if e.on_device and not e.pending:
                demote.append(e)
                dev -= e.nbytes
        return evicted, demote

    def _apply_rebalance(self, old, evict, demote):
        if old is not None:
            self._release_entry(old)
        for e in evict:
            self._release_entry(e)
        for e in demote:
            if e.kind == "blocks":
                self._demote_blocks(e)
            else:
                self._to_host(e)

    def _release_entry(self, entry):
        if entry.kind != "blocks" or entry.pending:
            return
        if entry.on_device and entry.blocks:
            entry.pool.free(entry.blocks)
        elif entry.handle is not None:
            entry.pool.drop_host(entry.handle)

    def _to_host(self, entry):
        """One dense entry's rows to host numpy (bit-exact)."""
        host = {n: _to_numpy(a) for n, a in entry.arrays.items()}
        with self._lock:
            if self._entries.get(entry.key) is entry and entry.on_device:
                entry.arrays = host
                entry.on_device = False
                self.page_outs += 1

    def _demote_blocks(self, entry):
        """One block entry's blocks to the pool's host tier (claim under
        the lock, copy outside, commit under it)."""
        pool = entry.pool
        with self._lock:
            if (self._entries.get(entry.key) is not entry
                    or not entry.on_device or entry.pending
                    or not entry.blocks):
                return
            ids = entry.blocks
            entry.blocks = None
            entry.on_device = False
            entry.pending = True
        handle = pool.to_host(ids)
        with self._lock:
            committed = self._entries.get(entry.key) is entry
            if committed:
                entry.handle = handle
                entry.pending = False
                self.page_outs += 1
                self.block_demotions += 1
        if not committed:
            pool.drop_host(handle)

    def page_out_all(self):
        """Every entry to the host tier; returns how many moved."""
        with self._lock:
            pending = [e for e in self._entries.values()
                       if e.on_device and not e.pending]
        for e in pending:
            if e.kind == "blocks":
                self._demote_blocks(e)
            else:
                self._to_host(e)
        return len(pending)

    def relieve_blocks(self, pool, need):
        """Demote cold device block entries of ``pool`` to the host tier
        until ``need`` blocks are available, least
        :func:`~mxnet_tpu_torch.serving.costs.eviction_score` first.
        Returns True when the pool can now grant ``need``."""
        now = time.monotonic()
        with self._lock:
            cands = sorted(
                (eviction_score(e.nbytes, now - e.last_used), e.key)
                for e in self._entries.values()
                if e.kind == "blocks" and e.pool is pool
                and e.on_device and not e.pending)
        for _score, key in cands:
            if pool.available() >= need:
                break
            with self._lock:
                e = self._entries.get(key)
            if e is not None:
                self._demote_blocks(e)
        return pool.available() >= need

    def device_block_count(self, pool):
        """Blocks this cache holds on the device for ``pool`` (what
        :meth:`relieve_blocks` could free)."""
        with self._lock:
            return sum(len(e.blocks) for e in self._entries.values()
                       if e.kind == "blocks" and e.pool is pool
                       and e.on_device and not e.pending and e.blocks)

    def clear(self):
        """Drop every entry, releasing block references and host handles.
        Returns the entries dropped."""
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
            self._order.clear()
            self.bytes = 0
        for e in dropped:
            self._release_entry(e)
        return len(dropped)

    # -- lookup ---------------------------------------------------------------
    def lookup(self, tokens, max_length=None):
        """Longest reusable prefix of ``tokens`` across the dense entries:
        (length, arrays) or (0, None); only the first ``length`` rows of
        the arrays are valid. A KV row at position t depends only on tokens
        0..t, so any entry sharing a common prefix donates its first rows.
        ``max_length`` bounds the prefix (the session passes ``len(prime) -
        1``: the last prompt token is always fed, its logits seed
        generation)."""
        toks = [int(t) for t in tokens]
        limit = len(toks) if max_length is None else min(len(toks),
                                                         int(max_length))
        with self._lock:
            best, best_len = self._best_locked(toks, limit, "rows")
            if best is None:
                self.misses += 1
                return 0, None
            self._touch_locked(best, best_len)
            return best_len, best.arrays

    def _best_locked(self, toks, limit, kind):
        best, best_len = None, 0
        for e in self._entries.values():
            if e.kind != kind or e.pending:
                continue
            lim = min(e.length, limit)
            if lim <= best_len:
                continue
            p = 0
            while p < lim and e.key[p] == toks[p]:
                p += 1
            if p > best_len:
                best, best_len = e, p
        return best, best_len

    def _touch_locked(self, entry, best_len):
        self._order.remove(entry.key)
        self._order.append(entry.key)
        entry.last_used = time.monotonic()
        self.hits += 1
        self.tokens_reused += best_len

    def acquire_blocks(self, tokens, max_length, pool):
        """Paged hit: the longest cached block prefix of ``tokens`` as
        ``(length, ids)``, one reference an id taken for the caller's
        table, or ``(0, None)``. A host-tier hit first uploads the entry
        into fresh blocks; with no room even after :meth:`relieve_blocks`
        the hit degrades to a miss. Worker thread only."""
        toks = [int(t) for t in tokens]
        limit = min(len(toks), int(max_length))
        with self._lock:
            best, best_len = self._best_locked(toks, limit, "blocks")
            if best is None or best_len < 1:
                self.misses += 1
                return 0, None
            self._touch_locked(best, best_len)
            nshare = pool.blocks_for_tokens(best_len)
            if best.on_device:
                ids = list(best.blocks[:nshare])
                pool.incref(ids)
                self.block_shares += len(ids)
                return best_len, ids
            handle = best.handle
            key = best.key
        if handle is None:
            return 0, None
        try:
            ids_full = pool.from_host(handle, drop=False)
        except KVPoolExhausted:
            self.relieve_blocks(pool, pool.blocks_for_tokens(best_len))
            try:
                ids_full = pool.from_host(handle, drop=False)
            except KVPoolExhausted:
                return 0, None
        with self._lock:
            e = self._entries.get(key)
            committed = (e is best and not e.on_device and not e.pending
                         and e.handle == handle)
            if committed:
                e.blocks = ids_full
                e.on_device = True
                e.handle = None
                self.block_promotes += 1
                ids = list(ids_full[:nshare])
                pool.incref(ids)
                self.block_shares += len(ids)
        if not committed:
            pool.free(ids_full)
            return 0, None
        pool.drop_host(handle)
        return best_len, ids

    # -- state ----------------------------------------------------------------
    def stats(self):
        with self._lock:
            vals = list(self._entries.values())
            dev_bytes = sum(e.nbytes for e in vals if e.on_device)
            return {
                "entries": len(vals),
                "device_entries": sum(1 for e in vals if e.on_device),
                "bytes": self.bytes,
                "device_bytes": dev_bytes,
                "host_bytes": self.bytes - dev_bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "page_outs": self.page_outs,
                "tokens_reused": self.tokens_reused,
                "block_entries": sum(1 for e in vals if e.kind == "blocks"),
                "device_block_entries": sum(
                    1 for e in vals if e.kind == "blocks" and e.on_device),
                "block_puts": self.block_puts,
                "block_shares": self.block_shares,
                "block_promotes": self.block_promotes,
                "block_demotions": self.block_demotions,
            }
