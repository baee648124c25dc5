"""GenerationSession: continuous batching for autoregressive decode
(reference: mxnet_tpu/serving/generation.py).

The session binds ``get_batch_decode_symbol`` executors over a fixed number
of KV-cache slots (``MXNET_SERVING_DECODE_SLOTS``): each slot is a row of
every layer's (slots, max_len, hidden) cache. New requests join the
in-flight batch at step boundaries, each row at its own position
(``BatchDecodeAttention`` masks each row to its own prefix, so a slot's
stream is the one that sequence decodes alone), and a finished sequence
frees its slot at once. Three pieces compose with it, each token-identical
to plain greedy decoding:

* chunked prefill (``MXNET_SERVING_PREFILL_CHUNK``): a second executor over
  the same weights and caches feeds up to K prompt tokens a row a step, so
  a P-token prompt costs ``ceil(P/K)`` steps, and a step that only
  prefills copies no probabilities to the host. The chunk is capped so a
  chunked step costs at most ``_STALL_FACTOR`` one-token steps by
  operation count (:mod:`~mxnet_tpu_torch.serving.costs`);
* prefix reuse (``MXNET_SERVING_PREFIX_CACHE_MB``): completed prompts and
  finished conversations park their KV rows in a
  :class:`~mxnet_tpu_torch.serving.prefix_cache.PrefixKVCache`; a prompt
  that extends a cached prefix restores those rows and prefills the rest;
* speculative decoding (``draft_params``, ``MXNET_SERVING_SPEC_K``): a draft
  lane proposes ``spec_k - 1`` tokens, the target verifies them in one
  chunked step and keeps the longest matching prefix plus its own token;

and paged KV (``MXNET_SERVING_KV_PAGED``): the lanes bind over a
:class:`~mxnet_tpu_torch.serving.kvpool.KVBlockPool` of blocks with
per-sequence block tables.

On the card every executor's forward is captured as one CUDA graph after
its eager warm-up and replayed (``step_graph.ForwardProgram``). The decode
ops write the new K/V rows into the bound caches in place and return them,
every other cache write here (a prefix restore, a slot's scrub, the pool's
fills, copies and uploads) is in place too, and the inputs are copied into
the bound arrays, so the graphs hold across steps. The steps run on the
session's worker thread; captures use ``capture_error_mode="thread_local"``,
so callers' threads may use the card meanwhile, and :meth:`warmup` runs
every bound program past its capture before traffic. The probabilities come
back to the host, where the tokens are picked, on steps where some row
samples.

Left out, as the reference's other tiers are not ported: the SLO scheduler
(``scheduler=`` raises), the recovery pager and device reset, fault
injection, tracing, the flight recorder, the ledger, memory tracking, the
SLO anomaly stream and the graphopt tuning artifact (the shipped defaults
and the env knobs apply). Each of those only observes: no token depends on
them.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .. import env
from ..base import MXNetError
from . import costs
from .errors import DeadlineExceeded, KVPoolExhausted, ServerClosed
from .metrics import ServingMetrics, percentile
from .prefix_cache import PrefixKVCache

__all__ = ["GenerationSession"]

_STALL_FACTOR = 8.0   # a prefill step may cost at most this many one-token
                      # decode steps (by operation count)


def _resolve(fut, value=None, exc=None):
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


def _copy_in(holder, host):
    """Copy the host array ``host`` into the bound NDArray ``holder``'s
    tensor in place (a captured graph keeps reading it); on the card
    through pinned memory, without waiting for the device."""
    import torch

    t = holder.data
    src = torch.from_numpy(np.ascontiguousarray(host)).to(t.dtype)
    if t.is_cuda:
        t.copy_(src.pin_memory(), non_blocking=True)
    else:
        t.copy_(src)


class _Seq:
    """One in-flight request: prime tokens to feed, then greedy
    continuation. ``fed`` is also the slot's next position."""

    __slots__ = ("prime", "gen_len", "future", "t_submit", "deadline",
                 "fed", "out", "slot", "t_first")

    def __init__(self, prime, gen_len, timeout_s=None):
        self.prime = [int(t) for t in prime]
        self.gen_len = int(gen_len)
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + timeout_s
                         if timeout_s is not None and timeout_s > 0 else None)
        self.fed = 0
        self.out = []
        self.slot = None
        self.t_first = None

    def stream(self):
        return self.prime + self.out

    def tokens(self):
        return np.asarray(self.prime + self.out, np.int64)


class _Lane:
    """One decode model bound over the session's slots: a one-token
    executor and/or a chunked one over the same weight and cache NDArrays.
    ``always_masked`` (the draft lane) binds only the chunked executor,
    whose idle rows (``nlen`` 0) write nothing. On the dense one-token
    executor an idle row writes position 0 of a free slot, which its next
    occupant overwrites before reading. A paged lane's executors are both
    masked (idle rows write the TRASH block); its one-token executor runs
    the steps that feed one token a row, as the dense lane's does, so a
    paged session runs the dense session's shapes (the reference's paged
    lane runs every step at the chunk)."""

    def __init__(self, arg_params, vocab_size, num_layers, hidden, heads,
                 max_len, slots, chunk, ctx, always_masked=False,
                 kv_cfg=None):
        from .. import ndarray as nd
        from ..models import transformer_lm

        self.vocab = int(vocab_size)
        self.max_len = int(max_len)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.heads = int(heads)
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.pool = None
        self.always_masked = bool(always_masked)
        self._kv_cfg = kv_cfg
        if kv_cfg is not None:
            from .kvpool import KV_RESERVED_BLOCKS, KVBlockPool

            dsym, self.cache_names = \
                transformer_lm.get_batch_decode_symbol(
                    vocab_size=vocab_size, num_layers=num_layers,
                    hidden=hidden, heads=heads, max_len=max_len,
                    chunk=self.chunk, paged=True)
            bs = int(kv_cfg["block"])
            span = -(-self.max_len // bs)
            block_nbytes = len(self.cache_names) * bs * self.hidden * 4
            mb = float(kv_cfg.get("mb") or 0.0)
            if mb > 0:
                nblocks = (KV_RESERVED_BLOCKS
                           + int(mb * (1 << 20) // block_nbytes))
            else:
                nblocks = (KV_RESERVED_BLOCKS
                           + int(kv_cfg.get("factor", 2))
                           * self.slots * span)
            self.pool = KVBlockPool(self.cache_names, bs, self.hidden,
                                    nblocks, self.max_len, ctx,
                                    name=str(kv_cfg.get("name",
                                                        "kvpool")))
            feed_shapes = {"data": (self.slots, self.chunk),
                           "pos": (self.slots, self.chunk),
                           "nlen": (self.slots,),
                           "btab": (self.slots, self.pool.table_width)}
            feed_shapes.update({n: (self.pool.num_blocks, bs, self.hidden)
                                for n in self.cache_names})
        else:
            dsym, self.cache_names = \
                transformer_lm.get_batch_decode_symbol(
                    vocab_size=vocab_size, num_layers=num_layers,
                    hidden=hidden, heads=heads, max_len=max_len)
            feed_shapes = {"data": (self.slots, 1), "pos": (self.slots,)}
            feed_shapes.update({n: (self.slots, self.max_len, self.hidden)
                                for n in self.cache_names})
        arg_shapes, _, _ = dsym.infer_shape(**feed_shapes)
        expect = dict(zip(dsym.list_arguments(), arg_shapes))
        needed = [n for n in dsym.list_arguments() if n not in feed_shapes]
        weights, missing = {}, []
        for pname in needed:
            val = arg_params.get(pname)
            if val is None:
                missing.append(pname)
                continue
            val = np.asarray(val.asnumpy() if hasattr(val, "asnumpy")
                             else val, np.float32)
            want = expect.get(pname)
            if want is not None and tuple(val.shape) != tuple(want):
                # a position table trained at seq_len < max_len would make
                # take() fill NaN embeddings past it, and one NaN KV row
                # corrupts its slot (0 * NaN)
                raise MXNetError(
                    f"GenerationSession: weight {pname!r} has shape "
                    f"{tuple(val.shape)} but the decode graph at "
                    f"max_len={self.max_len} needs {tuple(want)} "
                    "(serve with max_len matching the checkpoint's "
                    "trained window, e.g. its seq_len)")
            weights[pname] = nd.array(val, ctx)
        if missing:
            raise MXNetError(
                f"GenerationSession: checkpoint is missing weights "
                f"{sorted(missing)}")
        if self.pool is not None:
            self.caches = self.pool.pools
            self.tables = [[] for _ in range(self.slots)]
        else:
            self.caches = {n: nd.zeros((self.slots, self.max_len,
                                        self.hidden), ctx)
                           for n in self.cache_names}
            self.tables = None
        self._weights = weights
        self._ctx = ctx
        self._ex1 = None
        if not self.always_masked and (self.pool is None or self.chunk > 1):
            self._ex1 = self._bind(1)
        self._exk = None
        if self.pool is not None or self.chunk > 1:
            self._exk = self._bind(self.chunk)
        self.fed = [0] * self.slots   # draft-lane positions
        self.steps = 0
        self.chunk_steps = 0
        self.d2h = 0                  # probability copies to the host
        self.d2h_ms = []              # each copy's host ms (device idle)

    def _bind(self, chunk):
        """An executor of the decode graph at ``chunk`` over the lane's
        weights and caches (masked when chunked or paged)."""
        from .. import ndarray as nd
        from ..models import transformer_lm

        ctx, paged = self._ctx, self.pool is not None
        sym, _ = transformer_lm.get_batch_decode_symbol(
            vocab_size=self.vocab, num_layers=self.num_layers,
            hidden=self.hidden, heads=self.heads, max_len=self.max_len,
            chunk=chunk, paged=paged)
        args = dict(self._weights)
        args.update(self.caches)
        masked = paged or chunk > 1
        args["data"] = nd.zeros((self.slots, chunk), ctx)
        args["pos"] = nd.zeros((self.slots, chunk) if masked
                               else (self.slots,), ctx)
        if masked:
            args["nlen"] = nd.zeros((self.slots,), ctx)
        if paged:
            args["btab"] = nd.zeros((self.slots, self.pool.table_width),
                                    ctx)
        return sym.bind(ctx, args, grad_req="null")

    def executors(self):
        """The lane's bound executors by name."""
        return {n: ex for n, ex in (("one_token", self._ex1),
                                    ("chunked", self._exk))
                if ex is not None}

    def set_chunk(self, chunk):
        """Bind the chunked program at a new K; weights and caches stay."""
        chunk = int(chunk)
        if chunk == self.chunk:
            return
        self.chunk = chunk
        self._exk = None
        if chunk > 1 or self.pool is not None:
            self._exk = self._bind(chunk)
        if chunk == 1 and self.pool is not None:
            self._ex1 = None

    def step(self, feeds, want_probs):
        """One batched step. ``feeds``: ``(slot, tokens, start_pos)`` rows
        (unlisted rows idle). Returns the (slots, K, vocab) probabilities
        when ``want_probs`` (one copy to the host), else None."""
        kmax = max((len(t) for _, t, _ in feeds), default=1)
        if self._ex1 is not None and kmax == 1:
            ex, kk = self._ex1, 1
        else:
            ex, kk = self._exk, self.chunk
            self.chunk_steps += 1
        data = np.zeros((self.slots, kk), np.float32)
        if kk > 1 or self.pool is not None:
            pos = np.zeros((self.slots, kk), np.float32)
            nlen = np.zeros((self.slots,), np.float32)
            for idx, toks, start in feeds:
                n = len(toks)
                nlen[idx] = n
                data[idx, :n] = toks
                pos[idx] = np.minimum(start + np.arange(kk),
                                      self.max_len - 1)
            _copy_in(ex.arg_dict["nlen"], nlen)
            if self.pool is not None:
                # unmapped tail entries stay 0, the NULL block
                btab = np.zeros((self.slots, self.pool.table_width),
                                np.float32)
                for i, tbl in enumerate(self.tables):
                    if tbl:
                        btab[i, :len(tbl)] = tbl
                _copy_in(ex.arg_dict["btab"], btab)
        else:
            pos = np.zeros((self.slots,), np.float32)
            for idx, toks, start in feeds:
                data[idx, 0] = float(toks[0])
                pos[idx] = float(start)
        _copy_in(ex.arg_dict["data"], data)
        _copy_in(ex.arg_dict["pos"], pos)
        outs = ex.forward(is_train=False)
        # the caches come back as the bound arrays (written in place), so
        # this feedback rebinds nothing
        for n, o in zip(self.cache_names, outs[1:]):
            self.caches[n].alias(o)
        self.steps += 1
        if not want_probs:
            return None
        self.d2h += 1
        outs[0].wait_to_read()
        t0 = time.perf_counter()
        probs = outs[0].asnumpy()
        self.d2h_ms.append((time.perf_counter() - t0) * 1e3)
        return probs.reshape(self.slots, kk, self.vocab)

    # -- prefix KV --------------------------------------------------------------
    def capture(self, slot, length):
        """Device copies of slot ``slot``'s first ``length`` KV rows (what
        :class:`PrefixKVCache` stores; the slot's rows change in place
        later)."""
        return {n: self.caches[n].data[slot, :length].clone()
                for n in self.cache_names}

    def restore(self, slot, length, arrays):
        """Write a cached prefix into a slot's rows in place (bit-exact,
        from the device or the host tier) and zero the rest of the row."""
        import torch

        for n in self.cache_names:
            c = self.caches[n].data
            rows = arrays[n][:length]
            if not isinstance(rows, torch.Tensor):
                rows = torch.from_numpy(np.ascontiguousarray(rows))
            c[slot, :length].copy_(rows)
            c[slot, length:].zero_()

    def zero_slot(self, idx):
        """Zero a freed slot's KV rows in place: a stale row (worst case
        NaN) would reach the next occupant through 0 * NaN in the masked
        attention product. Paged lanes scrub freed blocks instead."""
        if self.pool is not None:
            return
        for n in self.cache_names:
            self.caches[n].data[idx].zero_()

    # -- paged pool -------------------------------------------------------------
    def prepare_feed(self, idx, start, n):
        """Make slot ``idx``'s table cover a write of ``n`` tokens at
        ``start..``: fresh blocks in one grant, then copy-on-write of any
        written block still shared. Worker thread only. Raises
        :class:`KVPoolExhausted` when the pool cannot cover it."""
        pool = self.pool
        bs = pool.block_tokens
        tbl = self.tables[idx]
        last = (start + n - 1) // bs
        grow = last + 1 - len(tbl)
        if grow > 0:
            tbl.extend(pool.alloc(grow))
        for si in range(start // bs, last + 1):
            if pool.refcount(tbl[si]) > 1:
                tbl[si] = pool.cow(tbl[si])
        pool.assert_owned(tbl[start // bs:last + 1])

    def adopt_blocks(self, idx, ids):
        """Seat a prefix hit: the shared blocks (one reference each, taken
        by the cache) head slot ``idx``'s table."""
        self.release_slot(idx)
        self.tables[idx] = list(ids)

    def blocks_for(self, idx, length):
        return list(self.tables[idx][:self.pool.blocks_for_tokens(length)])

    def release_slot(self, idx):
        tbl = self.tables[idx]
        self.tables[idx] = []
        if tbl:
            self.pool.free(tbl)


class GenerationSession:
    """Continuous-batching decode over fixed KV-cache slots.

    Parameters
    ----------
    arg_params : dict
        Weights (name -> NDArray or numpy array) in
        ``models.transformer_lm.get_symbol``'s names.
    vocab_size / num_layers / hidden / heads / max_len
        The decode graph's hyperparameters (the checkpoint's).
    slots : int, optional
        KV-cache slots (``MXNET_SERVING_DECODE_SLOTS``, default 4).
    ctx : Context, optional
        Device (default ``gpu(0)``; ``cpu()`` on request).
    scheduler
        The reference's SLO scheduler; not ported (raises).
    continuous : bool
        ``True``: requests join at any step boundary with a free slot;
        ``False``: FIFO re-batching, admissions wait until every slot is
        free.
    metrics : ServingMetrics, optional
    prefill_chunk : int, optional
        Prompt tokens fed a row a step (``MXNET_SERVING_PREFILL_CHUNK``,
        default 1), capped by operation count unless ``chunk_cost_cap`` is
        False.
    prefix_cache : PrefixKVCache | int | None
        A cache, or a budget in bytes (``MXNET_SERVING_PREFIX_CACHE_MB``;
        0/None: off).
    draft_params / draft_config / spec_k
        Speculative decoding: the draft's weights, its ``num_layers``/
        ``hidden``/``heads`` (default the target's), and the verify chunk
        (``MXNET_SERVING_SPEC_K``, default 4).
    kv_paged / kv_block / kv_pool_mb
        Paged KV (``MXNET_SERVING_KV_PAGED``, default off), tokens a block
        (``MXNET_SERVING_KV_BLOCK``, default 8), the pool budget in MiB
        (``MXNET_SERVING_KV_POOL_MB``, default 0: twice the dense layout).
    """

    def __init__(self, arg_params, vocab_size, num_layers=2, hidden=64,
                 heads=4, max_len=32, slots=None, ctx=None, scheduler=None,
                 continuous=True, metrics=None, name="decode",
                 prefill_chunk=None, chunk_cost_cap=True, prefix_cache=None,
                 draft_params=None, draft_config=None, spec_k=None,
                 kv_paged=None, kv_block=None, kv_pool_mb=None):
        if scheduler is not None:
            raise MXNetError("GenerationSession: scheduler= (the SLO "
                             "scheduler and its tenant quotas) is not "
                             "ported")
        if slots is None:
            slots = int(env.get_float("MXNET_SERVING_DECODE_SLOTS", 4,
                                      strict=True))
        if slots < 1:
            raise MXNetError("GenerationSession: slots must be >= 1")
        if prefill_chunk is None:
            prefill_chunk = int(env.get_float("MXNET_SERVING_PREFILL_CHUNK",
                                              1, strict=True))
        prefill_chunk = int(prefill_chunk)
        if not 1 <= prefill_chunk <= int(max_len):
            raise MXNetError(
                f"GenerationSession: prefill_chunk must be in [1, "
                f"max_len={int(max_len)}], got {prefill_chunk}")
        if spec_k is None:
            spec_k = int(env.get_float("MXNET_SERVING_SPEC_K", 0,
                                       strict=True)) or 4
        spec_k = int(spec_k)
        if draft_params is not None and spec_k < 2:
            raise MXNetError(
                f"GenerationSession: spec_k must be >= 2 (the draft "
                f"proposes spec_k-1 tokens per round), got {spec_k}")
        self._spec_k = spec_k if draft_params is not None else 0
        if kv_paged is None:
            kv_paged = env.get_bool("MXNET_SERVING_KV_PAGED", False)
        self._paged = bool(kv_paged)
        if kv_block is None:
            kv_block = int(env.get_float("MXNET_SERVING_KV_BLOCK", 8,
                                         strict=True))
        kv_block = int(kv_block)
        if self._paged and not 1 <= kv_block <= int(max_len):
            raise MXNetError(
                f"GenerationSession: kv_block must be in [1, "
                f"max_len={int(max_len)}], got {kv_block}")
        self._kv_block = kv_block
        if kv_pool_mb is None:
            kv_pool_mb = env.get_float("MXNET_SERVING_KV_POOL_MB", 0.0,
                                       strict=True)
        from ..context import gpu

        self.name = name
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.vocab_size = int(vocab_size)
        self._continuous = bool(continuous)
        self.metrics = metrics or ServingMetrics()
        ctx = ctx if ctx is not None else gpu(0)
        bind_chunk = max(prefill_chunk, self._spec_k, 1)
        kv_cfg = None
        if self._paged:
            kv_cfg = {"block": kv_block, "mb": kv_pool_mb, "factor": 2,
                      "name": f"{name}.kv"}
        self._target = _Lane(arg_params, vocab_size, num_layers, hidden,
                             heads, max_len, self.slots, bind_chunk, ctx,
                             kv_cfg=kv_cfg)
        self.chunk_requested = prefill_chunk
        self._prefill_chunk = prefill_chunk
        if chunk_cost_cap and bind_chunk > 1:
            self._prefill_chunk = min(prefill_chunk,
                                      self._cost_capped_chunk(bind_chunk))
            eff_bind = max(self._prefill_chunk, self._spec_k, 1)
            if eff_bind < bind_chunk:
                self._target.set_chunk(eff_bind if eff_bind > 1 else 1)
        self._draft = None
        if draft_params is not None:
            cfg = {"num_layers": num_layers, "hidden": hidden,
                   "heads": heads}
            cfg.update(draft_config or {})
            draft_kv = None
            if self._paged:
                # exactly slots x ceil(max_len / block) blocks: the draft
                # never shares, so its allocations never fail
                draft_kv = {"block": kv_block, "mb": 0, "factor": 1,
                            "name": f"{name}.draft_kv"}
            self._draft = _Lane(draft_params, vocab_size,
                                cfg["num_layers"], cfg["hidden"],
                                cfg["heads"], max_len, self.slots,
                                max(2, self._spec_k), ctx,
                                always_masked=True, kv_cfg=draft_kv)
        if prefix_cache is None:
            mb = env.get_float("MXNET_SERVING_PREFIX_CACHE_MB", 0,
                               strict=True)
            prefix_cache = int(mb * (1 << 20)) if mb > 0 else 0
        if isinstance(prefix_cache, PrefixKVCache):
            self._prefix = prefix_cache
        elif prefix_cache:
            self._prefix = PrefixKVCache(int(prefix_cache))
        else:
            self._prefix = None
        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._slots = [None] * self.slots    # worker-owned _Seq rows
        self._closed = False
        self.steps = 0
        self.slot_steps = 0
        self.tokens_out = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prefill_tokens = 0
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.row_restores = 0
        self.kv_sheds = 0
        self._ttfts = deque(maxlen=4096)
        self._worker = threading.Thread(target=self._worker_loop,
                                        name=f"mxtpu-serving-{name}",
                                        daemon=True)
        self._worker.start()

    def _cost_capped_chunk(self, bind_chunk):
        """The prefill chunk capped so a chunked step costs at most
        ``_STALL_FACTOR`` one-token steps, from the operation counts of the
        bound one-token and chunked programs."""
        c1 = costs.forward_flops(self._target._ex1)
        ck = costs.forward_flops(self._target._exk)
        return costs.prefill_chunk_cap(bind_chunk, c1, ck,
                                       stall_factor=_STALL_FACTOR)

    # -- client -------------------------------------------------------------------
    def generate(self, prime, gen_len, tenant=None, timeout_s=None):
        """Queue one greedy request: feed ``prime`` (>= 1 token ids), then
        sample ``gen_len`` tokens. Returns a Future of the (prime +
        generated) int64 tokens. A request still queued at its deadline
        (``timeout_s``) resolves with :class:`DeadlineExceeded`. One whose
        ``prime + gen_len`` does not fit ``max_len`` raises at once.
        ``tenant`` is the reference's argument; with no scheduler ported it
        changes nothing."""
        prime = [int(t) for t in np.asarray(prime).reshape(-1)]
        gen_len = int(gen_len)
        if not prime:
            raise MXNetError("generate: empty prime")
        if gen_len < 1:
            raise MXNetError("generate: gen_len must be >= 1")
        if len(prime) + gen_len > self.max_len:
            raise MXNetError(
                f"generate: prime ({len(prime)}) + gen_len ({gen_len}) "
                f"exceeds the bound context window max_len={self.max_len}")
        if self._paged:
            pool = self._target.pool
            need = pool.blocks_for_tokens(len(prime) + gen_len)
            if need > pool.capacity():
                raise MXNetError(
                    f"generate: sequence needs {need} KV blocks but the "
                    f"pool holds {pool.capacity()} — raise "
                    "MXNET_SERVING_KV_POOL_MB")
        if self._closed:
            raise ServerClosed("GenerationSession.generate after close()")
        seq = _Seq(prime, gen_len, timeout_s=timeout_s)
        self.metrics.on_submit(1)
        with self._cv:
            if self._closed:
                raise ServerClosed("generate after close()")
            self._pending.append(seq)
            self._cv.notify_all()
        return seq.future

    def warmup(self):
        """Run every bound program past its warm-up and capture before
        traffic: two synthetic greedy generates cover the chunked prefill,
        the one-token step, the draft and verify chunks and, with a prefix
        cache, the restore path (against a scratch cache, so no synthetic
        prefix stays)."""
        k = max(self._prefill_chunk, self._spec_k, 2)
        plen = max(2, min(2 * k + 1, self.max_len - 3))
        gen = max(1, min(self.max_len - plen, k + 5))
        scratch = None
        if self._prefix is not None:
            scratch = PrefixKVCache(1 << 40)
        real, self._prefix = self._prefix, scratch or self._prefix
        try:
            prime = [self.vocab_size - 1] * plen
            self.generate(prime, gen).result()
            self.generate(prime, gen).result()
        finally:
            self._prefix = real
            if scratch is not None:
                scratch.clear()

    def close(self, drain=True):
        """Stop admissions; ``drain`` finishes queued and in-flight
        sequences first, else queued requests fail with
        :class:`ServerClosed`."""
        with self._cv:
            self._closed = True
            dropped = []
            if not drain:
                dropped = list(self._pending)
                self._pending.clear()
            self._cv.notify_all()
        for seq in dropped:
            self.metrics.on_drop()
            self.metrics.on_complete(time.perf_counter() - seq.t_submit,
                                     failed=True)
            _resolve(seq.future, exc=ServerClosed("session closed"))
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- worker -------------------------------------------------------------------
    def _admissible(self, now):
        """Under the cv lock: (expired, admitted). Continuous mode seats
        into any free slot; FIFO mode only once every slot is free."""
        expired, keep = [], deque()
        for seq in self._pending:
            if seq.deadline is not None and now >= seq.deadline:
                expired.append(seq)
            else:
                keep.append(seq)
        self._pending = keep
        admitted = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        any_active = len(free) < self.slots
        if self._pending and free and (self._continuous or not any_active):
            cand = list(self._pending)
            budget = None
            if self._paged:
                # free blocks plus what demoting the prefix cache's device
                # blocks could free; stop at the first request that does
                # not fit (no starving the head of the queue)
                pool = self._target.pool
                budget = pool.available()
                if self._prefix is not None:
                    budget += self._prefix.device_block_count(pool)
            for seq in cand:
                if not free:
                    break
                if budget is not None:
                    need = pool.blocks_for_tokens(len(seq.prime) + 1)
                    if need > budget:
                        break
                    budget -= need
                idx = free.pop(0)
                self._slots[idx] = seq
                seq.slot = idx
                admitted.append(seq)
            if (self._paged and not admitted and not any_active and cand
                    and free):
                # nothing in flight would ever unblock the queue: seat the
                # head; the step's exhaustion path relieves or sheds typed
                seq = cand[0]
                idx = free.pop(0)
                self._slots[idx] = seq
                seq.slot = idx
                admitted.append(seq)
            taken = set(map(id, admitted))
            self._pending = deque(s for s in self._pending
                                  if id(s) not in taken)
        return expired, admitted

    def _seat(self, admitted):
        """Per-admission work outside the lock: reset the draft row, then
        restore the longest cached prefix of the prompt less its last
        token, and start prefill there."""
        for seq in admitted:
            idx = seq.slot
            if self._draft is not None:
                self._draft.fed[idx] = 0
                if self._paged:
                    self._draft.release_slot(idx)
            if self._paged:
                self._target.release_slot(idx)
            if self._prefix is None or len(seq.prime) < 2:
                continue
            if self._paged:
                ln, ids = self._prefix.acquire_blocks(
                    seq.prime, len(seq.prime) - 1, self._target.pool)
                if ln >= 1:
                    self._target.adopt_blocks(idx, ids)
            else:
                ln, arrays = self._prefix.lookup(
                    seq.prime, max_length=len(seq.prime) - 1)
                if ln >= 1:
                    self._target.restore(idx, ln, arrays)
                    self.row_restores += 1
            if ln >= 1:
                seq.fed = ln
                self.metrics.on_prefix_hit(ln)
            else:
                self.metrics.on_prefix_miss()

    def _worker_loop(self):
        while True:
            with self._cv:
                while True:
                    now = time.perf_counter()
                    expired, admitted = self._admissible(now)
                    active = [(i, s) for i, s in enumerate(self._slots)
                              if s is not None]
                    if expired or active:
                        break
                    if self._closed and not self._pending:
                        return
                    self._cv.wait()
            for seq in expired:
                waited = now - seq.t_submit
                self.metrics.on_expire(waited)
                _resolve(seq.future, exc=DeadlineExceeded(
                    f"decode request expired after {waited:.3f}s in the "
                    "session queue"))
            if admitted:
                self.metrics.on_dispatch(len(admitted), len(admitted),
                                         len(admitted))
            try:
                if admitted:
                    self._seat(admitted)
                if not active:
                    continue
                self._step(active)
            except Exception as e:   # fail the batch's requests, not the worker
                failed = [s for _i, s in active]
                with self._cv:
                    for i, _s in active:
                        self._slots[i] = None
                    self._cv.notify_all()
                now = time.perf_counter()
                for seq in failed:
                    _resolve(seq.future, exc=e)
                    self.metrics.on_complete(now - seq.t_submit,
                                             failed=True)
                continue
            self.steps += 1
            self.slot_steps += len(active)
            finished = [(i, s) for i, s in active
                        if len(s.out) >= s.gen_len]
            if finished:
                now = time.perf_counter()
                for _idx, seq in finished:
                    if self._prefix is not None and seq.fed >= 2:
                        if self._paged:
                            self._prefix.put_blocks(
                                seq.stream()[:seq.fed],
                                self._target.blocks_for(seq.slot,
                                                        seq.fed),
                                self._target.pool)
                        else:
                            self._prefix.put(seq.stream()[:seq.fed],
                                             self._target.capture(
                                                 seq.slot, seq.fed))
                    if self._paged:
                        self._target.release_slot(seq.slot)
                        if self._draft is not None:
                            self._draft.release_slot(seq.slot)
                    else:
                        self._target.zero_slot(seq.slot)
                        if self._draft is not None:
                            self._draft.zero_slot(seq.slot)
                with self._cv:
                    for idx, _seq in finished:
                        self._slots[idx] = None
                    self._cv.notify_all()
                for _idx, seq in finished:
                    _resolve(seq.future, value=seq.tokens())
                    self.metrics.on_complete(now - seq.t_submit)

    def _step(self, active):
        """One round: the draft's proposals, if any, then one target step
        that advances every active row by at least one token. The
        probabilities come to the host only when some row samples."""
        if self._paged:
            self._target.pool.scrub_dirty()
        proposals = self._propose(active) if self._draft is not None else {}
        rows = []
        feeds = []
        want_probs = False
        fed_prime = 0
        for idx, seq in active:
            stream = seq.stream()
            avail = len(stream) - seq.fed
            props = proposals.get(idx)
            if props:
                toks = [stream[seq.fed]] + props
                kind = "spec"
            else:
                n = min(self._prefill_chunk, avail) if avail > 1 else 1
                toks = stream[seq.fed:seq.fed + n]
                kind = "plain" if seq.fed + n == len(stream) else "prefill"
            if self._paged and not self._prepare_paged(idx, seq,
                                                       len(toks)):
                continue
            if kind != "prefill":
                want_probs = True
            fed_prime += max(0, min(seq.fed + len(toks), len(seq.prime))
                             - seq.fed)
            feeds.append((idx, toks, seq.fed))
            rows.append((seq, toks, kind))
        if not feeds:
            return
        t_step0 = time.perf_counter()
        probs = self._target.step(feeds, want_probs)
        now = time.perf_counter()
        self.metrics.on_step(now - t_step0, want_probs)
        if fed_prime:
            self.prefill_steps += 1
            self.prefill_tokens += fed_prime
        if want_probs:
            self.decode_steps += 1
        for (idx, toks, _start), (seq, _t, kind) in zip(feeds, rows):
            prev_fed = seq.fed
            if kind == "prefill":
                seq.fed += len(toks)
            elif kind == "plain":
                seq.fed += len(toks)
                tok = int(probs[idx, len(toks) - 1].argmax())
                self._emit(seq, [tok], now)
            else:
                # keep the longest draft prefix the target's own greedy
                # chain reproduces, plus the target's next token
                m = len(toks) - 1
                tgt = [int(probs[idx, j].argmax()) for j in range(m + 1)]
                n_acc = 0
                while n_acc < m and toks[1 + n_acc] == tgt[n_acc]:
                    n_acc += 1
                emitted = (toks[1:1 + n_acc] + [tgt[n_acc]])[
                    :seq.gen_len - len(seq.out)]
                seq.fed += len(emitted)
                self._emit(seq, emitted, now)
                self.spec_rounds += 1
                self.spec_proposed += m
                self.spec_accepted += n_acc
                self.metrics.on_spec(m, n_acc)
                # rejected proposals leave stale draft rows past the
                # accepted prefix: rewind the draft to the confirmed front
                self._draft.fed[idx] = min(self._draft.fed[idx], seq.fed)
            if (self._prefix is not None and not self._paged
                    and len(seq.prime) >= 2
                    and prev_fed < len(seq.prime) <= seq.fed):
                # the prompt is resident: park it for prefix reuse
                self._prefix.put(seq.prime, self._target.capture(
                    idx, len(seq.prime)))

    def _prepare_paged(self, idx, seq, ntoks):
        """Cover ``seq``'s next ``ntoks`` positions with blocks; on
        exhaustion demote cold prefix blocks to the host tier and retry
        once, else shed the sequence typed. Returns False when shed."""
        pool = self._target.pool
        try:
            self._target.prepare_feed(idx, seq.fed, ntoks)
            return True
        except KVPoolExhausted as e:
            need = (e.needed or 1) + 1   # +1: room for a copy-on-write
            if self._prefix is not None and \
                    self._prefix.relieve_blocks(pool, need):
                try:
                    self._target.prepare_feed(idx, seq.fed, ntoks)
                    return True
                except KVPoolExhausted:
                    pass
            self._shed_kv(idx, seq)
            return False

    def _shed_kv(self, idx, seq):
        """Free the victim's slot and blocks and resolve it with
        :class:`KVPoolExhausted`; the rest of the batch decodes on."""
        pool = self._target.pool
        self._target.release_slot(idx)
        if self._draft is not None:
            self._draft.release_slot(idx)
            self._draft.fed[idx] = 0
        with self._cv:
            self._slots[idx] = None
            self._cv.notify_all()
        self.kv_sheds += 1
        self.metrics.on_shed("kv_pool")
        _resolve(seq.future, exc=KVPoolExhausted(
            f"decode shed at {seq.fed} fed tokens: kv pool "
            f"{pool.name!r} exhausted ({pool.available()} of "
            f"{pool.capacity()} blocks free, host relief exhausted); "
            "back off and retry — blocks free as sequences finish",
            needed=pool.blocks_for_tokens(seq.fed + 1),
            free=pool.available()))
        self.metrics.on_complete(time.perf_counter() - seq.t_submit,
                                 failed=True)

    def _emit(self, seq, tokens, now):
        seq.out.extend(tokens)
        self.tokens_out += len(tokens)
        if seq.t_first is None and seq.out:
            seq.t_first = now
            ttft = now - seq.t_submit
            self._ttfts.append(ttft)
            self.metrics.on_ttft(ttft)

    def _propose(self, active):
        """The draft's half of a speculative round: for every decode row
        whose draft lag fits one chunk, catch the draft up to the target's
        front (one masked chunk step) and chain ``spec_k - 1`` greedy
        proposals. Rows still catching up decode plainly this round."""
        draft = self._draft
        m = self._spec_k - 1
        feeds, ready = [], []
        for idx, seq in active:
            stream = seq.stream()
            if len(stream) - seq.fed != 1 or \
                    seq.gen_len - len(seq.out) < 2:
                continue
            lag = seq.fed + 1 - draft.fed[idx]
            n = min(lag, draft.chunk)
            if n <= 0:
                continue
            toks = stream[draft.fed[idx]:draft.fed[idx] + n]
            if draft.pool is not None:
                draft.prepare_feed(idx, draft.fed[idx], n)
            feeds.append((idx, toks, draft.fed[idx]))
            if draft.fed[idx] + n == seq.fed + 1:
                ready.append((idx, len(toks) - 1))
        if not feeds:
            return {}
        probs = draft.step(feeds, bool(ready))
        for idx, toks, _s in feeds:
            draft.fed[idx] += len(toks)
        if not ready:
            return {}
        proposals = {idx: [int(probs[idx, col].argmax())]
                     for idx, col in ready}
        for _ in range(m - 1):
            pfeeds = [(idx, [proposals[idx][-1]], draft.fed[idx])
                      for idx, _c in ready]
            if draft.pool is not None:
                for idx, _c in ready:
                    draft.prepare_feed(idx, draft.fed[idx], 1)
            probs = draft.step(pfeeds, True)
            for idx, _c in ready:
                proposals[idx].append(int(probs[idx, 0].argmax()))
                draft.fed[idx] += 1
        return proposals

    # -- state --------------------------------------------------------------------
    def ttfts(self):
        """Time-to-first-token samples (seconds, oldest first)."""
        with self._cv:
            return list(self._ttfts)

    def programs(self):
        """Each bound executor's evaluation-forward state
        (``Executor.forward_info``: captured, warm-ups, captures, replays,
        drops), by lane and program."""
        lanes = {"target": self._target}
        if self._draft is not None:
            lanes["draft"] = self._draft
        return {f"{lane}.{name}": ex.forward_info()
                for lane, obj in lanes.items()
                for name, ex in obj.executors().items()}

    def stats(self):
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            pending = len(self._pending)
        ttfts = sorted(self._ttfts)
        d2h = sorted(self._target.d2h_ms)
        out = {
            "slots": self.slots,
            "active": active,
            "pending": pending,
            "steps": self.steps,
            "slot_steps": self.slot_steps,
            "tokens_out": self.tokens_out,
            "occupancy": (self.slot_steps / (self.steps * self.slots)
                          if self.steps else 0.0),
            "continuous": self._continuous,
            "chunk": self._prefill_chunk,
            "chunk_requested": self.chunk_requested,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            "d2h_syncs": self._target.d2h,
            "d2h_ms_p50": percentile(d2h, 50),
            "target_steps": self._target.steps,
            "chunk_steps": self._target.chunk_steps,
            "ttft_p50_ms": percentile(ttfts, 50) * 1e3,
            "ttft_p99_ms": percentile(ttfts, 99) * 1e3,
            "prefix_cache": (self._prefix.stats()
                             if self._prefix is not None else None),
            "paged": self._paged,
            "row_restores": self.row_restores,
        }
        if self._paged:
            out["kv_block"] = self._kv_block
            out["kv_sheds"] = self.kv_sheds
            out["kv_pool"] = self._target.pool.stats()
        if self._spec_k:
            out["spec"] = {
                "k": self._spec_k,
                "rounds": self.spec_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance": (self.spec_accepted
                               / max(self.spec_proposed, 1)),
                "draft_steps": self._draft.steps,
                "draft_d2h": self._draft.d2h,
            }
        return out
