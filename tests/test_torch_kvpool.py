"""The port's paged-KV allocator (counterpart of tests/test_kvpool.py's
allocator tests), on CPU tensors: atomic grants and refcounts, double-free
and reserved-id detection, typed exhaustion, zero-fill on free (NaN at rest
under ``MXNET_NAN_WATCHDOG``), copy-on-write, the host tier's bit-exact
round trip, the reset, the ownership assertion the decode op relies on, and
that every device mutation writes the pool tensors in place (a graph
captured over them keeps reading them)."""
import numpy as np
import pytest

import mxnet_tpu_torch as mxt
from mxnet_tpu.serving.kvpool import KV_RESERVED_BLOCKS as J_RESERVED
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import KVBlockPool, KVPoolExhausted
from mxnet_tpu_torch.serving.kvpool import KV_RESERVED_BLOCKS


def _pool(num_blocks=10, block_tokens=4, hidden=8, max_len=16):
    return KVBlockPool(["k", "v"], block_tokens, hidden, num_blocks,
                       max_len, mxt.cpu(), name="test")


def _block_host(pool, n, base=1.0):
    return {name: np.full((n, pool.block_tokens, pool.hidden), base + i,
                          np.float32)
            for i, name in enumerate(pool.cache_names)}


def _tensors(pool):
    return [pool.pools[n].data for n in pool.cache_names]


def test_reserved_ids_are_the_reference():
    assert KV_RESERVED_BLOCKS == J_RESERVED == 2


def test_alloc_free_refcount_invariants():
    pool = _pool()
    assert pool.capacity() == 10 - KV_RESERVED_BLOCKS
    assert pool.available() == pool.capacity()
    ids = pool.alloc(3)
    assert len(set(ids)) == 3
    assert all(b >= KV_RESERVED_BLOCKS for b in ids)
    assert all(pool.refcount(b) == 1 for b in ids)
    assert ids == [2, 3, 4]            # lowest id first out
    assert pool.available() == pool.capacity() - 3
    pool.free(ids[:1])
    assert pool.available() == pool.capacity() - 2
    st = pool.stats()
    assert st["used"] + st["free"] + st["dirty"] == st["capacity"]
    more = pool.alloc(4)
    pool.free(more[1:3])
    st = pool.stats()
    assert st["used"] + st["free"] + st["dirty"] == st["capacity"]
    assert st["allocs"] == 7 and st["frees"] == 3


def test_double_free_and_reserved_ids_rejected():
    pool = _pool()
    (b,) = pool.alloc(1)
    pool.free([b])
    with pytest.raises(MXNetError):
        pool.free([b])
    with pytest.raises(MXNetError):
        pool.free([0])
    with pytest.raises(MXNetError):
        pool.incref([b])


def test_exhaustion_is_typed_and_atomic():
    pool = _pool()
    ids = pool.alloc(pool.capacity())
    with pytest.raises(KVPoolExhausted) as ei:
        pool.alloc(2)
    assert ei.value.needed == 2 and ei.value.free == 0
    pool.free(ids[:1])
    with pytest.raises(KVPoolExhausted) as ei:
        pool.alloc(2)
    assert ei.value.free == 1
    assert pool.available() == 1
    assert pool.alloc(1)
    assert pool.stats()["alloc_fails"] == 2


def test_pool_too_small_for_one_sequence_rejected():
    with pytest.raises(MXNetError, match="cannot hold"):
        KVBlockPool(["k"], 4, 8, KV_RESERVED_BLOCKS + 3, 16, mxt.cpu())


def test_cow_lifecycle_share_diverge_release():
    pool = _pool()
    held = _tensors(pool)
    (b,) = pool.alloc(1)
    pool.write_blocks([b], _block_host(pool, 1, base=2.0))
    pool.incref([b])
    assert pool.refcount(b) == 2
    with pytest.raises(MXNetError, match="shared"):
        pool.assert_owned([b])
    nb = pool.cow(b)
    assert nb != b
    assert pool.refcount(b) == 1 and pool.refcount(nb) == 1
    pool.assert_owned([b, nb])
    got = pool.read_blocks([nb])
    for i, name in enumerate(pool.cache_names):
        np.testing.assert_array_equal(got[name][0], 2.0 + i)
    st = pool.stats()
    assert st["cow_copies"] == 1 and st["shares"] == 1
    pool.free([b])
    pool.free([nb])
    with pytest.raises(MXNetError):
        pool.assert_owned([nb])
    assert pool.available() == pool.capacity()
    assert all(a is t for a, t in zip(_tensors(pool), held))


def test_freed_blocks_zeroed_before_reuse():
    pool = _pool()
    (b,) = pool.alloc(1)
    pool.write_blocks([b], _block_host(pool, 1, base=7.0))
    pool.free([b])
    ids = pool.alloc(1)
    got = pool.read_blocks(ids)
    for name in pool.cache_names:
        assert not got[name].any()
    assert pool.stats()["scrubs"] >= 1


def test_watchdog_regime_poisons_free_blocks_and_cleans_at_alloc(
        monkeypatch):
    monkeypatch.setenv("MXNET_NAN_WATCHDOG", "1")
    pool = _pool()
    (b,) = pool.alloc(1)
    pool.write_blocks([b], _block_host(pool, 1, base=3.0))
    pool.free([b])
    pool.scrub_dirty()
    got = pool.read_blocks([b])
    assert all(np.isnan(got[name]).all() for name in pool.cache_names)
    got = pool.read_blocks(pool.alloc(1))
    for name in pool.cache_names:
        assert not got[name].any()
    st = pool.stats()
    assert st["poisons"] >= 1 and st["scrubs"] >= 1


def test_host_tier_round_trip_is_bit_exact():
    pool = _pool()
    ids = pool.alloc(2)
    rng = np.random.RandomState(0)
    host = {name: rng.randn(2, pool.block_tokens,
                            pool.hidden).astype(np.float32)
            for name in pool.cache_names}
    pool.write_blocks(ids, host)
    handle = pool.to_host(ids)
    assert pool.available() == pool.capacity()
    back = pool.from_host(handle)
    got = pool.read_blocks(back)
    for name in pool.cache_names:
        np.testing.assert_array_equal(got[name], host[name])
    assert pool.host_handles() == 0
    st = pool.stats()
    assert st["page_outs"] == 2 and st["page_ins"] == 2


def test_from_host_without_room_keeps_the_host_copy():
    pool = _pool()
    ids = pool.alloc(2)
    handle = pool.to_host(ids)
    rest = pool.alloc(pool.capacity())
    with pytest.raises(KVPoolExhausted):
        pool.from_host(handle)
    assert pool.host_handles() == 1
    pool.free(rest)
    assert len(pool.from_host(handle)) == 2


def test_reset_forgets_device_blocks_keeps_host_tier():
    pool = _pool()
    held = _tensors(pool)
    ids = pool.alloc(3)
    pool.write_blocks(ids[:1], _block_host(pool, 1, base=5.0))
    pool.write_blocks(ids[1:2], _block_host(pool, 1, base=9.0))
    handle = pool.to_host(ids[:1])
    pool.reset()
    assert pool.available() == pool.capacity()
    got = pool.read_blocks([ids[1]])
    for name in pool.cache_names:
        assert not got[name].any()
    back = pool.from_host(handle)
    got = pool.read_blocks(back)
    for i, name in enumerate(pool.cache_names):
        np.testing.assert_array_equal(got[name][0], 5.0 + i)
    assert all(a is t for a, t in zip(_tensors(pool), held))
