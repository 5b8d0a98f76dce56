"""Continuous batching (port of ``mxnet_tpu/models/serving.py``).

A fixed set of lanes decodes as one ragged batch (each lane at its own
position); requests are admitted into free lanes between dispatches and
leave when done. Ported, with the JAX batcher's semantics and argument
order:

* Dense lanes (``paged=False``, the default, as the JAX batcher's with
  ``MXNET_KV_PAGED`` unset): one [max_len] cache row per lane and the
  ragged ``decode_step`` (through the flash-decode kernel under
  ``cfg.use_flash_kernel``). Admission prefills at a power-of-two bucket
  width and copies the whole row into the lane, which clears the
  previous occupant's K/V.
* The paged KV cache (``paged=True``): one per-layer block pool plus a
  per-lane block table, read by the paged kernel (its int8 mode for an
  int8 pool). Admission accounts in blocks against a refcounting
  free-list allocator, reserving a request's whole lifetime up front and
  allocating blocks lazily as its position advances.
* Token choice on the device: greedy, or sampling under the pool's
  temperature / top_k / top_p with a per-request ``seed``. Each lane
  carries its request's (seed, counter) chain, so a sampled stream
  equals the request's solo ``generate(seed=...)`` at any lane, chunk
  size and depth (the noise is the port's own counter-based hash, not
  ``jax.random``'s).
* Chunked dispatch (``chunk_size=k``): k ragged steps per ``step()`` and
  one [k, B] fetch; a request ending mid-chunk keeps its prefix.
* Pipelined dispatch (``pipeline_depth=d``): lane tokens, positions and
  sampling counters (and the tables when paged) stay on the device, up
  to d chunks ride in flight, and each ``step()`` syncs only the oldest
  chunk's emissions, copied into pinned memory behind an event.
  Emissions are credited by the lane's request id at dispatch. Nothing
  of a dispatch or a lane patch reads the device from the host: the
  admission prefill and its first-token choice run on a side stream, so
  the one scalar admission pulls to the host does not wait for the
  chunks in flight, while every write to the lane cache, the pool, the
  tables or the carry stays on the main stream, ordered after the
  chunks that still read the old contents.
* Prefix caching (``cache_prefix``): an LRU of row caches (dense), or
  refcounted sharing of pool blocks with a copy-on-extend partial tail
  (paged).
* ``cancel(rid)`` and ``stream(requests)``.

Not ported, each raising NotImplementedError naming its ROADMAP item:
speculative dispatch (``spec_k``), priority preemption and idempotency
keys at admission (A4); brownout and the request journal (A10).
``enqueued_ns`` is accepted and ignored, as the JAX batcher ignores it
with telemetry off. Its observability, chaos and memory-budget hooks
have no counterpart.
"""

import collections
import contextlib

import numpy as np
import torch

from . import transformer as tf
from ..context import resolve_device

__all__ = ["DEFAULT_KV_BLOCK_SIZE", "BlockAllocator", "Request",
           "ContinuousBatcher"]

DEFAULT_KV_BLOCK_SIZE = 16

# constructor options of the JAX batcher that are not ported, and the
# ROADMAP item that brings each; None and False mean "off" for all
_LATER_OPTIONS = {"spec_ngram": "A4", "spec_accept_floor": "A4",
                  "draft_params": "A4", "draft_cfg": "A4",
                  "brownout": "A10", "brownout_attain": "A10",
                  "brownout_trip": "A10", "brownout_clear": "A10",
                  "journal": "A10"}


def _bucket(n, lo=8):
    b = lo
    while b < n:
        b *= 2
    return b


def _upload(array, device):
    """A host array as a new tensor on ``device``; on CUDA through pinned
    memory and an asynchronous copy, so the host never waits for the
    work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch_async(t):
    """(host copy, event): ``t`` copied into pinned memory behind the work
    queued so far, and the event that marks the copy done (None on the
    CPU, where the copy is done on return)."""
    if t.device.type != "cuda":
        return t.clone(), None
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return buf, event


class BlockAllocator(object):
    """Free-list allocator with per-block refcounts over the paged KV
    pool. Block 0 is the reserved null block (unallocated table entries
    point at it) and is never handed out. A block mapped into several
    tables (a shared prefix) carries one reference per mapping, prefix
    cache entry included, and returns to the free list only at refcount
    zero.

    ``reserved`` tracks the worst-case future block demand of admitted
    requests: admission reserves a request's whole lifetime, the lazy
    per-dispatch allocation converts reservation into blocks, and
    ``available`` (free minus reserved) is what admission may still
    promise, so a live request never stalls on an empty free list."""

    __slots__ = ("num_blocks", "ref", "reserved", "_free")

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is null)")
        self.num_blocks = int(num_blocks)
        # pop() hands out low ids first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.ref = np.zeros((self.num_blocks,), np.int32)
        self.reserved = 0

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def available(self):
        return len(self._free) - self.reserved

    def alloc(self, n):
        """n fresh blocks at refcount 1 (raises when the free list is
        short — callers gate on ``available``, so this firing means an
        accounting bug, not load)."""
        if n > len(self._free):
            raise RuntimeError(
                "paged KV free list exhausted (%d requested, %d free) "
                "— admission accounting should have prevented this"
                % (n, len(self._free)))
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self.ref[b] = 1
        return ids

    def share(self, ids):
        """One more reference on each block (a new table mapping)."""
        for b in ids:
            if self.ref[b] < 1:
                raise RuntimeError("sharing unallocated block %d" % b)
            self.ref[b] += 1

    def release(self, ids):
        """Drop one reference per block; a block frees at zero."""
        for b in ids:
            self.ref[b] -= 1
            if self.ref[b] < 0:
                raise RuntimeError("double free of block %d" % b)
            if self.ref[b] == 0:
                self._free.append(b)

    def reserve(self, n):
        self.reserved += int(n)

    def unreserve(self, n):
        self.reserved -= int(n)
        if self.reserved < 0:
            raise RuntimeError("reservation accounting underflow")

    def check_invariants(self, mappings=None, quiesce=False):
        """Structural audit; raises RuntimeError on the first violation,
        returns True otherwise.

        * conservation: every non-null block is either on the free list
          (refcount 0) or referenced (refcount >= 1), never both, never
          neither, and the free list holds no duplicates;
        * ``mappings`` (optional): block-id lists of the live tables and
          prefix entries — each block's refcount equals the number of
          mappings holding it, and no mapped block is free;
        * ``reserved`` never exceeds the free list;
        * ``quiesce=True``: nothing live remains — every block free,
          zero reservation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("free list holds duplicate block ids")
        if 0 in free:
            raise RuntimeError("null block 0 leaked onto the free list")
        if int(self.ref[0]) != 0:
            raise RuntimeError("null block 0 acquired a refcount")
        referenced = 0
        for b in range(1, self.num_blocks):
            r = int(self.ref[b])
            if b in free and r != 0:
                raise RuntimeError(
                    "block %d is free but refcount=%d" % (b, r))
            if b not in free and r < 1:
                raise RuntimeError(
                    "block %d leaked: refcount=%d and not free" % (b, r))
            if r >= 1:
                referenced += 1
        if len(free) + referenced != self.num_blocks - 1:
            raise RuntimeError(
                "pool conservation broken: %d free + %d referenced != %d "
                "non-null blocks" % (len(free), referenced,
                                     self.num_blocks - 1))
        if self.reserved < 0:
            raise RuntimeError("negative reservation")
        if self.reserved > len(self._free):
            raise RuntimeError(
                "reserved %d exceeds free list %d — admission promised "
                "blocks that cannot be delivered"
                % (self.reserved, len(self._free)))
        if mappings is not None:
            want = {}
            for blocks in mappings:
                for b in blocks:
                    want[b] = want.get(b, 0) + 1
            for b, n in want.items():
                if b in free:
                    raise RuntimeError(
                        "mapped block %d sits on the free list" % b)
                if int(self.ref[b]) != n:
                    raise RuntimeError(
                        "block %d refcount=%d but %d mappings hold it"
                        % (b, int(self.ref[b]), n))
            for b in range(1, self.num_blocks):
                if int(self.ref[b]) > 0 and b not in want:
                    raise RuntimeError(
                        "block %d refcount=%d but no mapping holds it "
                        "(leak)" % (b, int(self.ref[b])))
        if quiesce:
            if self.reserved != 0:
                raise RuntimeError(
                    "quiesce with %d blocks still reserved" % self.reserved)
            if len(self._free) != self.num_blocks - 1:
                raise RuntimeError(
                    "quiesce with %d of %d blocks leaked"
                    % (self.num_blocks - 1 - len(self._free),
                       self.num_blocks - 1))
        return True


class Request(object):
    __slots__ = ("rid", "tokens", "n_new", "emitted", "stop_token", "seed")

    def __init__(self, rid, prompt, n_new, stop_token=None, seed=0):
        self.rid = rid
        self.tokens = list(prompt)   # prompt + generated so far
        self.n_new = n_new
        self.emitted = 0             # generated count
        self.stop_token = stop_token
        self.seed = seed             # sampling seed

    @property
    def done(self):
        """Budget exhausted, or the stop token was emitted (the stop
        token itself is part of the stream)."""
        if self.emitted >= self.n_new:
            return True
        return (self.stop_token is not None and self.emitted > 0
                and self.tokens[-1] == self.stop_token)


class ContinuousBatcher(object):
    """Lane-based continuous batching over a shared ragged decode step.

    >>> srv = ContinuousBatcher(params, cfg, max_batch=8)
    >>> rid = srv.admit([1, 2, 3], n_new=16)      # None when full
    >>> finished = srv.step()                     # {rid: [tokens...]}

    Decoding is greedy by default; pool-level temperature / top_k /
    top_p sample instead (generate()'s rule, greedy=False for pure
    ancestral sampling), with a per-request ``seed`` at admit(). Either
    way a request's stream equals its solo ``generate()``.

    ``params`` is a :class:`~.transformer.TransformerLM` on ``device``
    (the current CUDA device by default; raises when there is none).
    ``chunk_size`` steps run per dispatch, ``pipeline_depth`` dispatches
    ride in flight, ``prefix_cache_slots`` bounds the prefix cache.
    ``paged=True`` serves the block pool: ``block_size`` (default 16)
    must divide ``cfg.max_len``, and ``num_blocks`` defaults to a
    full-context row per lane plus the null block. See the module
    docstring for what each mode does and what is not ported."""

    def __init__(self, params, cfg, max_batch=8, greedy=None,
                 temperature=1.0, top_k=None, top_p=None, chunk_size=1,
                 prefix_cache_slots=4, pipeline_depth=1, paged=None,
                 block_size=None, num_blocks=None, name=None, spec_k=None,
                 device=None, **later):
        for option, value in later.items():
            if option not in _LATER_OPTIONS:
                raise TypeError("unexpected keyword argument %r" % option)
            if value is not None and value is not False:
                raise NotImplementedError(
                    "%s=%r waits for ROADMAP item %s"
                    % (option, value, _LATER_OPTIONS[option]))
        tf._check_supported(cfg)
        if cfg.max_len < 8:
            raise ValueError("max_len too small for the bucket floor")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if spec_k:
            raise NotImplementedError(
                "speculative dispatches (spec_k=%r) wait for ROADMAP item "
                "A4" % (spec_k,))
        self.greedy = tf._resolve_greedy(greedy, temperature, top_k, top_p)
        self._controls = (self.greedy, float(temperature), top_k, top_p)
        self.device = resolve_device(device)
        tf._check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.chunk_size = int(chunk_size)
        self.pipeline_depth = int(pipeline_depth)
        self.name = name
        # decode dispatches issued (one per chunk)
        self.dispatch_count = 0
        self._device_carry = self.pipeline_depth > 1
        self.paged = bool(paged)
        b, dev = self.max_batch, self.device
        if self.paged:
            self.block_size = int(block_size or DEFAULT_KV_BLOCK_SIZE)
            if cfg.max_len % self.block_size:
                raise ValueError("block_size %d must divide max_len %d"
                                 % (self.block_size, cfg.max_len))
            self._nb = cfg.max_len // self.block_size      # table width
            if num_blocks is None:
                num_blocks = self.max_batch * self._nb + 1
            self.num_blocks = int(num_blocks)
            self._alloc = BlockAllocator(self.num_blocks)
            self._pool = tf.init_paged_cache(cfg, self.num_blocks,
                                             self.block_size, dev)
            self._tables = torch.zeros((b, self._nb), dtype=torch.int32,
                                       device=dev)
            self._lane_blocks = [[] for _ in range(b)]
            self._lane_need = [0] * b
            # a lane's position after every dispatched chunk (the
            # pipelined carry never syncs it): drives block allocation
            self._sched_pos = np.zeros((b,), np.int64)
            self._cache = None
        else:
            self._cache = tf.init_cache(cfg, b, dev)
        # the lanes' state on the host (synchronous dispatch) ...
        self._pos = np.zeros((b,), np.int32)
        self._tok = np.zeros((b,), np.int32)
        self._seed = np.zeros((b,), np.int64)
        self._ctr = np.zeros((b,), np.int64)    # the next token's counter
        # ... or on the device between pipelined dispatches
        if self._device_carry:
            self._dev_tok = torch.zeros((b,), dtype=torch.int32, device=dev)
            self._dev_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
            self._dev_seed = torch.zeros((b,), dtype=torch.int64, device=dev)
            self._dev_ctr = torch.zeros((b,), dtype=torch.int64, device=dev)
            # in flight, oldest first: (host emissions [k, B], the event
            # marking them copied, each lane's request id at dispatch)
            self._inflight = collections.deque()
        # a batcher lane draws row 0 of its request's batch-1 chain
        self._rows = torch.zeros((b,), dtype=torch.int64, device=dev)
        # admission prefills off the main stream when chunks ride in
        # flight; _pool_event marks the last prefix block write, which a
        # side-stream gather must follow
        self._side = (torch.cuda.Stream(dev)
                      if self._device_carry and dev.type == "cuda" else None)
        self._pool_event = None
        self._slots = [None] * b   # Request or None
        # prefix cache, LRU order (oldest first): tuple(tokens) ->
        # (row cache, last-row logits) dense, (block ids, logits) paged
        self._prefix_cache = {}
        self._prefix_slots = int(prefix_cache_slots)
        self._next_rid = 0

    # ---- capacity and audit ----

    @property
    def active_count(self):
        return sum(1 for s in self._slots if s is not None)

    @property
    def has_capacity(self):
        """A free lane and, when paged, at least one block of unpromised
        capacity (or an evictable prefix entry); a specific prompt's
        demand is checked by admit() itself."""
        if self.active_count >= self.max_batch:
            return False
        if self.paged:
            return self._alloc.available >= 1 or bool(self._prefix_cache)
        return True

    @property
    def free_blocks(self):
        """Unallocated pool blocks (None when not paged)."""
        return self._alloc.free_blocks if self.paged else None

    def check_invariants(self, quiesce=False):
        """Audit the lanes and, when paged, the block accounting against
        every live mapping — lane tables plus prefix entries (see
        BlockAllocator.check_invariants). ``quiesce=True`` also demands
        zero live lanes and, with no prefix cached, a whole free list."""
        if quiesce and self.active_count:
            raise RuntimeError(
                "quiesce with %d live requests" % self.active_count)
        if not self.paged:
            return True
        mappings = [b for b in self._lane_blocks if b]
        mappings += [blocks for blocks, _ in self._prefix_cache.values()]
        self._alloc.check_invariants(
            mappings=mappings, quiesce=quiesce and not self._prefix_cache)
        for i, req in enumerate(self._slots):
            if req is None and (self._lane_blocks[i] or self._lane_need[i]):
                raise RuntimeError("freed lane %d still holds blocks" % i)
        return True

    # ---- streams and device helpers ----

    @contextlib.contextmanager
    def _side_stream(self):
        """Run the body on the admission stream (pipelined, on CUDA),
        after the last prefix block write; else on the current one."""
        if self._side is None:
            yield
            return
        if self._pool_event is not None:
            self._side.wait_event(self._pool_event)
        with torch.cuda.stream(self._side):
            yield

    def _join_side(self, row):
        """Order the main stream after the admission stream, and keep the
        row cache it made alive until the main stream has read it."""
        if self._side is None:
            return
        main = torch.cuda.current_stream(self.device)
        main.wait_stream(self._side)
        for layer in row:
            for leaf in layer.values():
                leaf.record_stream(main)

    def _tokens(self, rows):
        return _upload(np.asarray(rows, np.int64), self.device)

    def _choose(self, logits, seeds, counters):
        return tf._choose_tokens(logits, self._controls, seeds, counters,
                                 self._rows[:logits.shape[0]])

    def _set_lane(self, i, tok, pos, seed, ctr):
        """Lane i's (token, position, seed, counter): on the host, or
        patched into the device carry after the chunks in flight."""
        seed = tf._seed_word(seed)
        if self._device_carry:
            self._patch_lane(i, tok, pos, seed, ctr)
        else:
            self._tok[i], self._pos[i] = tok, pos
            self._seed[i], self._ctr[i] = seed, ctr

    def _patch_lane(self, i, tok, pos, seed, ctr):
        for leaf, value in ((self._dev_tok, tok), (self._dev_pos, pos),
                            (self._dev_seed, seed), (self._dev_ctr, ctr)):
            leaf[i].fill_(value)

    # ---- prefix cache ----

    def _lookup_prefix(self, prompt):
        """Longest cached prefix of ``prompt`` -> (p_len, entry),
        LRU-refreshed; (0, None) on a miss."""
        best = None
        for key in self._prefix_cache:
            if len(key) <= len(prompt) and tuple(prompt[:len(key)]) == key \
                    and (best is None or len(key) > len(best)):
                best = key
        if best is None:
            return 0, None
        hit = self._prefix_cache.pop(best)
        self._prefix_cache[best] = hit               # LRU refresh
        return len(best), hit

    def _evict_prefixes(self, demand, keep=None):
        """LRU-evict cached prefixes until ``demand`` blocks are
        available; an entry whose every block a live lane also holds
        would free nothing and is skipped, and ``keep`` shields the entry
        an admission is about to share. False when nothing evictable is
        left."""
        while self._alloc.available < demand:
            victim = next(
                (k for k in self._prefix_cache if k != keep
                 and any(self._alloc.ref[b] == 1
                         for b in self._prefix_cache[k][0])), None)
            if victim is None:
                return False
            blocks, _ = self._prefix_cache.pop(victim)
            self._alloc.release(blocks)
        return True

    @torch.no_grad()
    def cache_prefix(self, tokens):
        """Prefill ``tokens`` once, at their exact length (so nothing
        stale lies past them), and keep the result: a later admit() whose
        prompt starts with these tokens prefills only its suffix. Dense:
        an LRU of ``prefix_cache_slots`` row caches with their last-row
        logits. Paged: the prefix lives in pool blocks held by the entry,
        a nested cached prefix's full blocks are shared into it, and
        admissions share its full blocks (the partial tail is copied).
        Returns the prefix length."""
        if self._prefix_slots < 1:
            raise ValueError("prefix caching disabled "
                             "(prefix_cache_slots=0)")
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not toks:
            raise ValueError("empty prefix")
        if len(toks) >= self.cfg.max_len:
            raise ValueError("prefix %d must leave room under max_len %d"
                             % (len(toks), self.cfg.max_len))
        if self.paged:
            return self._cache_prefix_paged(toks)
        key = tuple(toks)
        hit = self._prefix_cache.pop(key, None)
        if hit is None:
            with self._side_stream():
                row = tf.init_cache(self.cfg, 1, self.device)
                logits, row = tf.prefill_chunk(
                    self.params, row, self._tokens([toks]), 0, self.cfg,
                    logits_row=len(toks) - 1)
            hit = (row, logits)
        self._prefix_cache[key] = hit                # insert / refresh
        while len(self._prefix_cache) > self._prefix_slots:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))
        return len(toks)

    def _cache_prefix_paged(self, toks):
        key = tuple(toks)
        hit = self._prefix_cache.pop(key, None)
        if hit is not None:
            self._prefix_cache[key] = hit            # LRU refresh
            return len(toks)
        p, bs = len(toks), self.block_size
        p_sub, sub = self._lookup_prefix(toks)
        sub_blocks = sub[0] if sub else []
        s = p_sub // bs
        own_n = -(-p // bs) - s
        if own_n > self._alloc.available and not self._evict_prefixes(
                own_n, keep=tuple(toks[:p_sub]) if p_sub else None):
            raise RuntimeError(
                "no free KV blocks for a %d-token prefix (%d needed, %d "
                "available)" % (p, own_n, self._alloc.available))
        with self._side_stream():
            row = (self._gather_row(sub_blocks[:-(-p_sub // bs)]) if p_sub
                   else tf.init_cache(self.cfg, 1, self.device))
            logits, row = tf.prefill_chunk(
                self.params, row, self._tokens([toks[p_sub:]]), p_sub,
                self.cfg, logits_row=p - p_sub - 1)
        self._join_side(row)
        own = self._alloc.alloc(own_n)
        self._alloc.share(sub_blocks[:s])
        self._block_write(row, own, s * bs)
        if self._side is not None:
            self._pool_event = torch.cuda.Event()
            self._pool_event.record()
        self._prefix_cache[key] = (sub_blocks[:s] + own, logits)
        while len(self._prefix_cache) > self._prefix_slots:
            blocks, _ = self._prefix_cache.pop(next(iter(self._prefix_cache)))
            self._alloc.release(blocks)
        return p

    # ---- admission ----

    def _block_math(self, t_p, total_len):
        """(lifetime_blocks, init_blocks) for a request whose final
        stream is ``total_len`` tokens from a ``t_p``-token prompt: the
        deepest cache write of its life is position total_len - 2 (the
        final token is never written), and admission must also cover
        position t_p, the first decode write."""
        last_pos = max(t_p, total_len - 2)
        return (last_pos // self.block_size + 1,
                t_p // self.block_size + 1)

    def _gather_row(self, ids):
        """Pool blocks ``ids`` gathered into a fresh [1, max_len] row
        cache (zero past them)."""
        row = tf.init_cache(self.cfg, 1, self.device)
        idx = _upload(np.asarray(ids, np.int64), self.device)
        n = len(ids) * self.block_size
        for layer_pool, layer_row in zip(self._pool, row):
            for name, leaf in layer_pool.items():
                layer_row[name][0, :n] = leaf[idx].reshape(
                    (n,) + tuple(leaf.shape[2:]))
        return row

    def _block_write(self, row, ids, start):
        """Row-cache positions [start, start + len(ids) * bs) into pool
        blocks ``ids``, whole blocks, so a reused block is overwritten."""
        n, bs = len(ids), self.block_size
        if not n:
            return
        idx = _upload(np.asarray(ids, np.int64), self.device)
        for layer_pool, layer_row in zip(self._pool, row):
            for name, leaf in layer_pool.items():
                rows = layer_row[name][0, start:start + n * bs]
                leaf.index_copy_(0, idx, rows.reshape(
                    (n, bs) + tuple(leaf.shape[2:])).to(leaf.dtype))

    def _dense_prefill(self, prompt, t_p):
        """(last-token logits [vocab], [1, max_len] row cache): the
        longest cached prefix's row (copied, as prefill writes in place)
        with the suffix prefilled at its bucket width."""
        p_len, hit = self._lookup_prefix(prompt)
        if hit is None:
            row = tf.init_cache(self.cfg, 1, self.device)
        else:
            row, pfx_logits = hit
            if p_len == t_p:
                return pfx_logits[0], row
            row = [{n: leaf.clone() for n, leaf in layer.items()}
                   for layer in row]
        return self._prefill_suffix(prompt, t_p, p_len, row)

    def _paged_prefill(self, prompt, t_p, p_len, pfx_blocks, pfx_logits):
        """As _dense_prefill, the prefix read from its pool blocks; the
        shared blocks themselves stay untouched."""
        if p_len:
            row = self._gather_row(pfx_blocks[:-(-p_len // self.block_size)])
            if p_len == t_p:
                return pfx_logits[0], row
        else:
            row = tf.init_cache(self.cfg, 1, self.device)
        return self._prefill_suffix(prompt, t_p, p_len, row)

    def _prefill_suffix(self, prompt, t_p, p_len, row):
        # one width per bucket, clamped to the cache (the JAX package
        # compiles one program per bucket; the port keeps the widths so
        # both write the same rows); rows past t_p are pad that decode
        # overwrites before attention can reach them
        width = min(_bucket(t_p - p_len), self.cfg.max_len - p_len)
        padded = np.zeros((1, width), np.int64)
        padded[0, :t_p - p_len] = prompt[p_len:]
        logits, row = tf.prefill_chunk(
            self.params, row, self._tokens(padded), p_len, self.cfg,
            logits_row=t_p - p_len - 1)
        return logits[0], row

    def _paged_map_lane(self, slot, t_p, row, p_len, pfx_blocks, lifetime,
                        init_n):
        """Map a lane's table for a fresh admission: the cached prefix's
        full blocks are shared in place, the rest through position t_p
        is freshly allocated and written whole from the row cache
        (copy-on-extend for a partial prefix tail), the rest of the
        lifetime is reserved for the lazy extension, and unneeded entries
        stay on the null block."""
        shared = p_len // self.block_size
        own = self._alloc.alloc(init_n - shared)
        self._alloc.share(pfx_blocks[:shared])
        self._alloc.reserve(lifetime - init_n)
        self._block_write(row, own, shared * self.block_size)
        lane = list(pfx_blocks[:shared]) + own
        trow = np.zeros((self._nb,), np.int32)
        trow[:len(lane)] = lane
        self._tables[slot].copy_(_upload(trow, self.device))
        self._lane_blocks[slot] = lane
        self._lane_need[slot] = lifetime
        self._sched_pos[slot] = t_p

    def _slot_write(self, slot, row):
        """The whole [max_len] row into lane ``slot``: the full copy is
        what clears the previous occupant's K/V past the new prompt's
        bucket."""
        for layer_cache, layer_row in zip(self._cache, row):
            for name, leaf in layer_cache.items():
                leaf[slot].copy_(layer_row[name][0])

    def _ensure_coverage(self, k):
        """Allocate, from the admission reservation, the blocks the next
        k decode positions of every live lane write. Entries past a
        lane's lifetime stay null: a request that ends mid-chunk coasts
        its remaining writes into the null block."""
        bs = self.block_size
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            pos = int(self._sched_pos[i] if self._device_carry
                      else self._pos[i])
            end = min((pos + k - 1) // bs, self._lane_need[i] - 1,
                      self._nb - 1)
            while len(self._lane_blocks[i]) <= end:
                bid = self._alloc.alloc(1)[0]
                self._alloc.unreserve(1)
                self._tables[i, len(self._lane_blocks[i])].fill_(bid)
                self._lane_blocks[i].append(bid)

    @torch.no_grad()
    def admit(self, prompt, n_new, seed=0, stop_token=None, enqueued_ns=None,
              priority=0, key=None):
        """Prefill ``prompt`` into a free lane; returns the request id, or
        None when no lane (or, paged, not enough unpromised blocks) is
        free. The first generated token comes from the prefill logits,
        so a request with n_new=1 never occupies a decode step. ``seed``
        drives this request's sampling chain (ignored under greedy), as
        generate(seed=...) would. ``stop_token`` ends the request when
        emitted (it is part of the returned stream)."""
        if priority != 0:
            raise NotImplementedError(
                "priority admission (KV-pressure preemption) waits for "
                "ROADMAP item A4")
        if key is not None:
            raise NotImplementedError(
                "idempotency keys wait for ROADMAP item A4")
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        t_p = len(prompt)
        if t_p < 1:
            raise ValueError("empty prompt")
        if t_p + n_new > self.cfg.max_len:
            raise ValueError("prompt+n_new %d exceeds max_len %d"
                             % (t_p + n_new, self.cfg.max_len))
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            return None
        if self.paged:
            p_len, hit = self._lookup_prefix(prompt)
            pfx_blocks, pfx_logits = hit if hit else ([], None)
            lifetime, init_n = self._block_math(t_p, t_p + n_new)
            demand = lifetime - p_len // self.block_size
            if demand > self.num_blocks - 1:
                raise ValueError(
                    "request needs %d KV blocks but the pool has only %d "
                    "usable (num_blocks=%d incl. the null block)"
                    % (demand, self.num_blocks - 1, self.num_blocks))
            if demand > self._alloc.available and not self._evict_prefixes(
                    demand, keep=tuple(prompt[:p_len]) if p_len else None):
                return None
        with self._side_stream():
            if self.paged:
                last, row = self._paged_prefill(prompt, t_p, p_len,
                                                pfx_blocks, pfx_logits)
            else:
                last, row = self._dense_prefill(prompt, t_p)
            seeds = torch.full((1,), tf._seed_word(seed), dtype=torch.int64,
                               device=self.device)
            counters = torch.zeros((1,), dtype=torch.int64,
                                   device=self.device)
            # the one host read of an admission; on the side stream it
            # waits for this prefill only
            first = int(self._choose(last[None], seeds, counters)[0])
        self._join_side(row)
        if self.paged:
            self._paged_map_lane(slot, t_p, row, p_len, pfx_blocks,
                                 lifetime, init_n)
        else:
            self._slot_write(slot, row)
        # next decode writes position t_p with the chain's counter 1
        self._set_lane(slot, first, t_p, seed, 1)
        req = Request(self._next_rid, prompt, n_new, stop_token, seed)
        self._next_rid += 1
        req.tokens.append(first)
        req.emitted = 1
        self._slots[slot] = req
        return req.rid

    # ---- decode ----

    def _run_chunk(self, tok, pos, seeds, counters):
        """chunk_size ragged decode steps with the token choice on the
        device: ([k, B] int32 emissions, and the lanes' next token,
        position and counter)."""
        outs = []
        for _ in range(self.chunk_size):
            if self.paged:
                logits, self._pool = tf.decode_step_paged(
                    self.params, self._pool, self._tables, tok, pos,
                    self.cfg)
            else:
                logits, self._cache = tf.decode_step(
                    self.params, self._cache, tok, pos, self.cfg)
            tok = self._choose(logits, seeds, counters)
            outs.append(tok)
            pos = pos + 1
            if counters is not None:
                counters = counters + 1
        return torch.stack(outs), tok, pos, counters

    def _credit(self, i, req, toks):
        """Lane i's emissions of one chunk ([k] of ``toks``) onto
        ``req``, up to its stop token or budget; True when it is done."""
        for t in toks[:, i]:
            req.tokens.append(int(t))
            req.emitted += 1
            if req.done:
                break
        return req.done

    @torch.no_grad()
    def step(self):
        """One scheduling step: ``chunk_size`` ragged decode steps in one
        dispatch. Appends up to chunk_size tokens to every active request
        (a request ending mid-chunk keeps its prefix) and returns {rid:
        full token list} for the requests that finished (their lanes are
        freed). With pipeline_depth > 1 it tops the window up to depth
        dispatches and syncs only the oldest one's emissions: the same
        contract, tokens arriving dispatches later."""
        finished = {}
        # retire requests complete at admission (n_new=1, or a stop
        # token straight out of the prefill logits)
        for i, req in enumerate(self._slots):
            if req is not None and req.done:
                finished[req.rid] = list(req.tokens)
                self._free(i)
        if self._device_carry:
            return self._step_pipelined(finished)
        if not self.active_count:
            return finished
        k = self.chunk_size
        if self.paged:
            self._ensure_coverage(k)
        seeds = counters = None
        if not self.greedy:
            seeds = _upload(self._seed, self.device)
            counters = _upload(self._ctr, self.device)
        toks = self._run_chunk(_upload(self._tok, self.device),
                               _upload(self._pos, self.device), seeds,
                               counters)[0].cpu().numpy()
        self.dispatch_count += 1
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            done = self._credit(i, req, toks)
            # every lane advanced k steps wherever its request ended
            self._pos[i] += k
            self._tok[i] = toks[k - 1, i]
            self._ctr[i] += k
            if done:
                finished[req.rid] = list(req.tokens)
                self._free(i)
        return finished

    def _step_pipelined(self, finished):
        while (len(self._inflight) < self.pipeline_depth
               and self.active_count):
            self._dispatch_chunk()
        if self._inflight:
            finished.update(self._sync_oldest())
        if not self.active_count:
            # the chunks still in flight advance parked lanes only
            self._inflight.clear()
        return finished

    def _dispatch_chunk(self):
        """Issue one chunk against the device carry, its emissions copied
        to pinned memory behind an event, and snapshot each lane's
        request id: the identity that decides at sync whose stream the
        emissions belong to."""
        if self.paged:
            self._ensure_coverage(self.chunk_size)
        seeds, counters = ((None, None) if self.greedy
                           else (self._dev_seed, self._dev_ctr))
        toks, self._dev_tok, self._dev_pos, counters = self._run_chunk(
            self._dev_tok, self._dev_pos, seeds, counters)
        if counters is not None:
            self._dev_ctr = counters
        self.dispatch_count += 1
        if self.paged:
            self._sched_pos += self.chunk_size
        buf, event = _fetch_async(toks)
        self._inflight.append(
            (buf, event, [r.rid if r is not None else None
                          for r in self._slots]))

    def _sync_oldest(self):
        """Credit the oldest chunk's emissions to the requests that held
        each lane at its dispatch and still do: a lane freed or
        re-admitted since is skipped, a request ending mid-chunk keeps
        its prefix. The only host wait of the pipelined loop."""
        buf, event, lanes = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        toks = buf.numpy()
        finished = {}
        for i, rid in enumerate(lanes):
            req = self._slots[i]
            if rid is None or req is None or req.rid != rid or req.done:
                continue
            if self._credit(i, req, toks):
                finished[req.rid] = list(req.tokens)
                self._free(i)
        return finished

    def cancel(self, rid):
        """Evict a request mid-decode; returns the tokens emitted so far
        (under pipelining, synced so far), or None when ``rid`` is not
        active. The other lanes' streams are untouched."""
        for i, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                out = list(req.tokens)
                self._free(i)
                return out
        return None

    def _free(self, i):
        """Free lane i and park it at position 0 (on an all-null table
        when paged, where its garbage K/V lands in the null block): its
        blocks and the unused tail of its reservation return to the
        allocator, a shared block only with its last reference. Under
        pipelining the park is a patch after the chunks in flight, whose
        writes through the old table are overwritten whole before a
        reused block is read."""
        self._slots[i] = None
        if self.paged:
            blocks = self._lane_blocks[i]
            self._alloc.release(blocks)
            self._alloc.unreserve(self._lane_need[i] - len(blocks))
            self._lane_blocks[i] = []
            self._lane_need[i] = 0
            self._sched_pos[i] = 0
            self._tables[i].zero_()
        self._set_lane(i, 0, 0, 0, 0)

    # ---- drivers ----

    def _admit_job(self, job):
        """(prompt, n_new[, seed[, stop_token[, priority]]]) -> rid or
        None."""
        return self.admit(job[0], job[1],
                          seed=job[2] if len(job) > 2 else 0,
                          stop_token=job[3] if len(job) > 3 else None,
                          priority=job[4] if len(job) > 4 else 0)

    def run(self, requests):
        """Serve ``requests`` (an iterable of (prompt, n_new[, seed[,
        stop_token[, priority]]])) through the lanes, admitting as
        capacity frees. Returns ({rid: tokens} for all of them, the
        admission order as a list of rids)."""
        queue = list(requests)
        order, results = [], {}
        while queue or self.active_count:
            while queue and self.has_capacity:
                rid = self._admit_job(queue[0])
                if rid is None:
                    break
                order.append(rid)
                queue.pop(0)
            results.update(self.step())
        return results, order

    def stream(self, requests):
        """Streaming driver: yields ``(rid, token, done)`` as each token
        is produced — the first right at admission, then up to
        chunk_size per step per active lane; ``done`` marks a request's
        final token. The same admission policy and streams as run(). A
        request cancel()ed between yields gets one terminal ``(rid, None,
        True)`` event."""
        queue = list(requests)
        live = {}                  # rid -> Request
        while queue or self.active_count:
            while queue and self.has_capacity:
                rid = self._admit_job(queue[0])
                if rid is None:
                    break
                queue.pop(0)
                req = next(r for r in self._slots
                           if r is not None and r.rid == rid)
                live[rid] = req
                yield rid, req.tokens[-1], req.done
            already = {rid: req.emitted for rid, req in live.items()}
            finished = self.step()
            for rid, req in list(live.items()):
                grew = req.emitted - already[rid]
                for off in range(grew):
                    yield (rid, req.tokens[-grew + off],
                           off == grew - 1 and rid in finished)
                if rid in finished:
                    del live[rid]
                elif req not in self._slots:
                    # cancel()ed between yields: step() never reports it
                    yield rid, None, True
                    del live[rid]
