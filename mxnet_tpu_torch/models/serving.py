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
* Speculative dispatch (``spec_k=k``, greedy only): each round drafts k
  tokens a lane, by n-gram lookup over the lane's own stream
  (``spec_ngram``, default 2) or by a draft model (``draft_params`` and
  ``draft_cfg``, dense or paged on the target's tables), and verifies
  every lane's [k + 1] window in one ragged pass (``verify_chunk``, or
  ``verify_chunk_paged`` through the paged kernel at span k + 1), with
  the acceptance test on the device; ``chunk_size`` rounds make a
  dispatch and ``pipeline_depth`` dispatches ride in flight, as above.
  A lane's draft width adapts to its acceptance (``spec_accept_floor``),
  paged coverage is reserved for the worst case and released at the
  sync for drafts that were rejected.
* Prefix caching (``cache_prefix``): an LRU of row caches (dense), or
  refcounted sharing of pool blocks with a copy-on-extend partial tail
  (paged).
* ``cancel(rid)`` and ``stream(requests)``.
* Robustness: ``admit(priority=...)`` preempts lower-priority lanes
  under block pressure onto ``self.preempted``, ``admit_continuation``
  resumes such a stream (a sampled one continues its noise counter, so
  it equals its uninterrupted run), ``shrink_pool`` / ``grow_pool`` park
  and return pool capacity, a failed dispatch requeues the live requests
  from their synced tokens (up to three in a row; a CUDA error that
  loses the context re-raises at once; ``dispatch_failures`` counts the
  requeues over the batcher's life), ``admit(key=...)`` deduplicates,
  and ``weight_fingerprint`` / ``health_snapshot`` report the replica. A
  paged dispatch that runs out of memory (``membudget.
  is_resource_exhausted``: a ``torch.cuda.OutOfMemoryError`` or the
  allocator's RESOURCE_EXHAUSTED text) parks a quarter of the pool
  through ``shrink_pool`` instead, and the next ``step()`` retries with
  the lanes intact.
* Durability: ``journal=`` (a directory or a
  :class:`~.journal.RequestJournal`; None and False are off, as the JAX
  batcher's with ``MXNET_SERVING_JOURNAL_DIR`` unset) appends a record at
  every admission and continuation, every synced emission (where the
  pipelined and speculative modes read their pinned buffers: no device
  synchronisation of its own), every preemption and every finish or
  cancel; streams and ``dispatch_count`` are the same with it on and
  off. ``recover()`` replays it after a crash: finished streams come
  back through the next ``step()``, live ones resume through
  ``admit_continuation`` (a sampled one at its noise counter, so it
  equals its uninterrupted run). ``swap_weights(params, manifest)``
  hot-swaps the served weights behind the checkpoint lineage gate
  without dropping a request.
* Chaos sites under the JAX package's names: ``serving.dispatch`` (or
  ``serving.dispatch.<name>`` for a named replica) before every
  dispatch, ``kv.pool.grow`` and ``serving.swap``.

Not ported: brownout raises naming ROADMAP item A10, which also brings
the memory budget (so ``swap_weights`` always reports
``mode="resident"``) and telemetry. ``enqueued_ns`` and ``preempted_ns``
are accepted and ignored, as the JAX batcher ignores them with
telemetry off.
"""

import collections
import contextlib
import json
import os
import time

import numpy as np
import torch

from . import checkpoint as _ckpt
from . import journal as _journal
from . import transformer as tf
from ..context import resolve_device
from ..observability import chaos as _chaos
from ..observability import membudget as _membudget

__all__ = ["DEFAULT_KV_BLOCK_SIZE", "BlockAllocator", "Request",
           "ContinuousBatcher", "params_fingerprint"]

DEFAULT_KV_BLOCK_SIZE = 16

# constructor options of the JAX batcher that are not ported, and the
# ROADMAP item that brings each; None and False mean "off" for all
_LATER_OPTIONS = {"brownout": "A10", "brownout_attain": "A10",
                  "brownout_trip": "A10", "brownout_clear": "A10"}


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


def params_fingerprint(params):
    """8-hex id of a TransformerLM's weights: the JAX package's
    ``observability.integrity.tree_fingerprint``, a crc32 fold over the
    sorted entries' names, dtypes, shapes and exact bytes, under the names
    its checkpoint manifests flatten the tree to ("p.embed",
    "p.layers.0.wq", ...), so the same weights give the same id in both
    packages, and the manifest's ``param_fingerprint``. An int8 tree
    folds each weight's codes, scales and dtype carrier as JAX flattens
    them ("p.layers.0.wq#q8", ...)."""
    entries = []
    for name, t in tf.flat_tensors(params).items():
        t = t.detach().to("cpu").contiguous()
        entries.append(("p." + name, _ckpt._dtype_name(t), t.shape,
                        _ckpt._to_numpy(t).tobytes()))
    return _ckpt.fingerprint_entries(entries)


# ---- speculative rounds -------------------------------------------------
# Batched draft/verify/accept: each round proposes k tokens per lane,
# verifies every lane's [k + 1] window in one ragged target pass, and rolls
# each lane forward by its own accepted count, all on the device.
# Rejected cache entries heal by position (the next window starts at the
# first rejected position and rewrites everything it will attend).

# smoothing of the per-lane acceptance EWMA the adaptive-k controller
# compares against spec_accept_floor
_SPEC_EWMA_ALPHA = 0.3


def _ngram_propose(hist, tok, pos, keff, k, ng):
    """Prompt-lookup drafting on the device: for each lane, the latest
    earlier occurrence of the ng-token suffix ending at the lane's current
    token (hist[b, pos[b]] == tok[b]; hist[b, :pos[b] + 1] is prompt and
    emissions), and the k tokens that followed it. A lane with no match,
    or a match whose continuation runs past the known stream, repeats its
    current token. Draft slots at or past keff[b] are the -1 sentinel,
    which no token equals: the adaptive k inside a fixed-width window.
    Returns int32 [B, k]."""
    b, hl = hist.shape
    device = hist.device
    j = torch.arange(hl, device=device)
    pos = pos.long()
    sidx = (pos[:, None] - (ng - 1)
            + torch.arange(ng, device=device)[None]).clamp(0, hl - 1)
    suffix = hist.gather(1, sidx)                               # [B, ng]
    m = torch.ones((b, hl), dtype=torch.bool, device=device)
    for o in range(ng):
        m = m & (torch.roll(hist, -o, dims=1) == suffix[:, o:o + 1])
    # a candidate ends strictly before the suffix's own end: no self-match,
    # and roll's wrapped columns stay out of range
    valid = (j[None, :] + ng - 1) < pos[:, None]
    best = torch.where(m & valid, j[None, :], -1).amax(dim=1)
    gidx = best[:, None] + ng + torch.arange(k, device=device)[None]
    cand = hist.gather(1, gidx.clamp(0, hl - 1))
    usable = (best[:, None] >= 0) & (gidx <= pos[:, None])
    drafts = torch.where(usable, cand, tok[:, None].to(hist.dtype))
    slot = torch.arange(k, device=device)[None]
    return torch.where(slot < keff[:, None], drafts, -1).to(torch.int32)


def _accept(drafts, target):
    """The acceptance of a round: each lane's count of drafts matching the
    target argmax as a prefix, emit = that + 1 (the window always yields
    one token past the accepted prefix), and the lane's next token,
    target[accepted]. Returns (emit int32 [B], tok int32 [B])."""
    k = drafts.shape[1]
    acc = torch.cumprod((drafts == target[:, :k]).to(torch.int64),
                        dim=1).sum(dim=1)
    tok = target.gather(1, acc[:, None])[:, 0]
    return (acc + 1).to(torch.int32), tok


def _context_lost(device):
    """True when a dispatch on ``device`` failed with a CUDA error that
    poisons the context ("sticky": an illegal address, a device-side
    assert, a trap): every later synchronisation of the device raises it
    again, so a requeue onto it cannot succeed."""
    if device.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(device)
    except RuntimeError:
        return True
    return False


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
    promise, so a live request never stalls on an empty free list.

    The pool is elastic: :meth:`shrink` moves free blocks onto a parked
    ledger, never below what ``reserved`` has promised, :meth:`grow`
    returns them, and :meth:`extend` adds new block ids after the batcher
    grew the pool itself. Parked blocks stay in the conservation law
    (pool == free + referenced + parked)."""

    __slots__ = ("num_blocks", "ref", "reserved", "_free", "_parked")

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is null)")
        self.num_blocks = int(num_blocks)
        # pop() hands out low ids first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self.ref = np.zeros((self.num_blocks,), np.int32)
        self.reserved = 0
        self._parked = []     # blocks out of circulation (shrink)

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def available(self):
        return len(self._free) - self.reserved

    @property
    def parked_blocks(self):
        return len(self._parked)

    def shrink(self, n):
        """Park up to ``n`` free blocks, never below the admission promise
        (``reserved`` stays deliverable). Returns the count parked."""
        take = max(min(int(n), len(self._free) - self.reserved), 0)
        for _ in range(take):
            self._parked.append(self._free.pop())
        return take

    def grow(self, n):
        """Return up to ``n`` parked blocks to the free list. Returns the
        count returned."""
        give = max(min(int(n), len(self._parked)), 0)
        for _ in range(give):
            self._free.append(self._parked.pop())
        return give

    def extend(self, n):
        """``n`` new block ids (the pool's block axis just grew): widen the
        refcounts and free the new ids, at the front of the pop-from-end
        free list so low ids keep being handed out first. Returns them."""
        n = int(n)
        if n <= 0:
            return []
        ids = list(range(self.num_blocks, self.num_blocks + n))
        self.num_blocks += n
        self.ref = np.concatenate([self.ref, np.zeros((n,), np.int32)])
        self._free = ids[::-1] + self._free
        return ids

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
        * parked blocks are disjoint from the free list, carry refcount 0
          and hold no duplicates, and free + referenced + parked is the
          pool;
        * ``quiesce=True``: nothing live remains — every block free or
          parked, zero reservation."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("free list holds duplicate block ids")
        parked = set(self._parked)
        if len(parked) != len(self._parked):
            raise RuntimeError("parked ledger holds duplicate block ids")
        if parked & free:
            raise RuntimeError(
                "blocks %s both parked and free" % sorted(parked & free))
        if 0 in free:
            raise RuntimeError("null block 0 leaked onto the free list")
        if 0 in parked:
            raise RuntimeError("null block 0 leaked onto the parked ledger")
        if int(self.ref[0]) != 0:
            raise RuntimeError("null block 0 acquired a refcount")
        referenced = 0
        for b in range(1, self.num_blocks):
            r = int(self.ref[b])
            if b in parked:
                if r != 0:
                    raise RuntimeError(
                        "block %d is parked but refcount=%d" % (b, r))
                continue
            if b in free and r != 0:
                raise RuntimeError(
                    "block %d is free but refcount=%d" % (b, r))
            if b not in free and r < 1:
                raise RuntimeError(
                    "block %d leaked: refcount=%d and not free" % (b, r))
            if r >= 1:
                referenced += 1
        if len(free) + referenced + len(parked) != self.num_blocks - 1:
            raise RuntimeError(
                "pool conservation broken: %d free + %d referenced + %d "
                "parked != %d non-null blocks"
                % (len(free), referenced, len(parked), self.num_blocks - 1))
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
            if len(self._free) + len(self._parked) != self.num_blocks - 1:
                raise RuntimeError(
                    "quiesce with %d of %d blocks leaked"
                    % (self.num_blocks - 1 - len(self._free)
                       - len(self._parked), self.num_blocks - 1))
        return True


class Request(object):
    __slots__ = ("rid", "tokens", "n_new", "emitted", "stop_token", "seed",
                 "priority", "key")

    def __init__(self, rid, prompt, n_new, stop_token=None, seed=0,
                 priority=0, key=None):
        self.rid = rid
        self.tokens = list(prompt)   # prompt + generated so far
        self.n_new = n_new
        self.emitted = 0             # generated count
        self.stop_token = stop_token
        self.seed = seed             # sampling seed (a requeue needs it)
        self.priority = int(priority)  # larger = more important
        self.key = key               # idempotency key (dedup window)

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
    full-context row per lane plus the null block. ``spec_k`` turns each
    dispatch into speculative rounds (greedy only): ``spec_ngram`` sets
    the n-gram drafts' suffix length (2), ``draft_params`` with
    ``draft_cfg`` draft with a model instead, and ``spec_accept_floor``
    (0.0, off) narrows a lane's drafts while its acceptance is under it.
    ``journal`` (a directory or a RequestJournal) records every request
    for :meth:`recover`. See the module docstring for what each mode does
    and what is not ported."""

    def __init__(self, params, cfg, max_batch=8, greedy=None,
                 temperature=1.0, top_k=None, top_p=None, chunk_size=1,
                 prefix_cache_slots=4, pipeline_depth=1, paged=None,
                 block_size=None, num_blocks=None, name=None, spec_k=None,
                 spec_ngram=None, spec_accept_floor=None, draft_params=None,
                 draft_cfg=None, device=None, journal=None, **later):
        for option, value in later.items():
            if option not in _LATER_OPTIONS:
                raise TypeError("unexpected keyword argument %r" % option)
            if value is not None and value is not False:
                raise NotImplementedError(
                    "%s=%r waits for ROADMAP item %s"
                    % (option, value, _LATER_OPTIONS[option]))
        if cfg.max_len < 8:
            raise ValueError("max_len too small for the bucket floor")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
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
        self._chaos_site = ("serving.dispatch" if name is None
                            else "serving.dispatch.%s" % name)
        # the request write-ahead journal: a directory or a RequestJournal;
        # None and False are off
        if isinstance(journal, (str, os.PathLike)):
            journal = _journal.RequestJournal(journal)
        self._journal = journal or None
        # speculative dispatches (spec_k drafts verified per round)
        self.spec_k = int(spec_k) if spec_k else None
        self._spec_on = self.spec_k is not None
        if self._spec_on:
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if not self.greedy:
                raise ValueError(
                    "speculative dispatches are greedy-only: the accept "
                    "test compares drafts against the target argmax (drop "
                    "spec_k to sample)")
            self.spec_ngram = int(2 if spec_ngram is None else spec_ngram)
            if self.spec_ngram < 1:
                raise ValueError("spec_ngram must be >= 1")
            self.spec_accept_floor = float(spec_accept_floor or 0.0)
            if (draft_params is None) != (draft_cfg is None):
                raise ValueError("draft_params and draft_cfg come as a pair")
            if draft_cfg is not None:
                if draft_cfg.vocab_size != cfg.vocab_size:
                    raise ValueError("draft vocab %d != target vocab %d"
                                     % (draft_cfg.vocab_size,
                                        cfg.vocab_size))
                if draft_cfg.max_len < cfg.max_len:
                    raise ValueError(
                        "draft max_len %d < target max_len %d — the draft "
                        "cache shares the target's lane positions"
                        % (draft_cfg.max_len, cfg.max_len))
                tf._check_params_device(draft_params, self.device)
            self.draft_params = draft_params
            self.draft_cfg = draft_cfg
            self._spec_provider = ("model" if draft_params is not None
                                   else "ngram")
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError("a draft model without spec_k does nothing — "
                             "set spec_k")
        else:
            self.spec_ngram = None
            self.spec_accept_floor = 0.0
            self.draft_params = self.draft_cfg = None
            self._spec_provider = None
        # target-model dispatches issued (one per chunk, pipelined chunk or
        # speculative dispatch): the denominator of dispatches per token
        self.dispatch_count = 0
        # dispatches that raised and were requeued, over the batcher's
        # life (never reset: a requeue hides its failure from the streams)
        self.dispatch_failures = 0
        # speculative decode keeps the carry on the device even at depth 1
        # (positions advance by accepted counts, known only there)
        self._device_carry = self.pipeline_depth > 1 or self._spec_on
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
        self._init_lanes()
        # a batcher lane draws row 0 of its request's batch-1 chain
        self._rows = torch.zeros((b,), dtype=torch.int64, device=dev)
        # admission prefills off the main stream when chunks ride in
        # flight; _pool_event marks the last prefix block write, which a
        # side-stream gather must follow
        self._side = (torch.cuda.Stream(dev)
                      if self._device_carry and dev.type == "cuda" else None)
        self._pool_event = None
        if self._spec_on:
            # drafts proposed and accepted over the batcher's life
            self._spec_drafted = 0
            self._spec_accepted = 0
        # dispatch-failure requeue: consecutive failures past the cap
        # re-raise (a deterministic fault must not loop)
        self._dispatch_failures = 0
        self._max_dispatch_failures = 3
        # prefix cache, LRU order (oldest first): tuple(tokens) ->
        # (row cache, last-row logits) dense, (block ids, logits) paged
        self._prefix_cache = {}
        self._prefix_slots = int(prefix_cache_slots)
        # priority preemption's victims, (Request, preempt_ns), for run()
        # (or the caller) to resume through admit_continuation()
        self.preempted = []
        # idempotency window: key -> live rid, key -> (rid, tokens) once
        # finished; re-deliveries ride the next step()
        self._idem = {}
        self._idem_done = {}
        self._pending_finished = {}
        self._weight_fp = None
        self._next_rid = 0

    def _init_lanes(self):
        """The lanes' state from scratch: empty slots, a zero cache or a
        fresh pool, tables and allocator, a zero carry and, under spec_k,
        fresh draft state. The constructor's, and the requeue's after a
        failed dispatch."""
        cfg, b, dev = self.cfg, self.max_batch, self.device
        self._slots = [None] * b   # Request or None
        if self.paged:
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
            # in flight, oldest first: (host emissions, the event marking
            # them copied, each lane's request id at dispatch[, the draft
            # widths of a speculative dispatch])
            self._inflight = collections.deque()
        self._dpool = self._dcache = self._dev_hist = None
        if self._spec_on:
            # per-lane adaptive k: the effective draft width (masked in
            # the fixed-width window) and the acceptance EWMA it follows
            self._keff = np.full((b,), self.spec_k, np.int32)
            self._accept_ewma = np.ones((b,), np.float64)
            if self._spec_provider == "ngram":
                # each lane's stream (prompt + emissions) by position; the
                # last column takes the writes past max_len
                self._dev_hist = torch.zeros((b, cfg.max_len + 1),
                                             dtype=torch.int32, device=dev)
            elif self.paged:
                # the draft pool shares the target's block tables: one
                # ledger for both models (so no prefix sharing)
                self._dpool = tf.init_paged_cache(
                    self.draft_cfg, self.num_blocks, self.block_size, dev)
            else:
                self._dcache = tf.init_cache(self.draft_cfg, b, dev)

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

    @property
    def weight_fingerprint(self):
        """8-hex id of the served weights (:func:`params_fingerprint`,
        computed once: the parameters are fixed for the batcher's life).
        The same id as the JAX batcher's for the same weights."""
        if self._weight_fp is None:
            self._weight_fp = params_fingerprint(self.params)
        return self._weight_fp

    def health_snapshot(self):
        """The replica's routing signals under the JAX batcher's names:
        lane occupancy, the weight fingerprint, the pool's headroom when
        paged, the speculative acceptance when spec_k is set.
        ``serving.slo_attainment`` is None: the rolling SLO window is not
        ported, and None is what the JAX batcher reports before any
        completion."""
        active = self.active_count
        snap = {
            "serving.lane_occupancy": active,
            "serving.lane_utilization": active / float(self.max_batch),
            "serving.slo_attainment": None,
            "serving.weight_fingerprint": self.weight_fingerprint,
            "serving.weight_version": int(self.weight_fingerprint, 16),
        }
        if self.paged:
            usable = self.num_blocks - 1
            snap["serving.kv_free_blocks"] = self._alloc.free_blocks
            snap["serving.kv_available_blocks"] = self._alloc.available
            snap["serving.kv_block_utilization"] = \
                (usable - self._alloc.free_blocks) / float(usable)
            if self._alloc.parked_blocks:
                snap["serving.kv_parked_blocks"] = self._alloc.parked_blocks
        if self._journal is not None:
            snap["serving.journal_depth_bytes"] = self._journal.depth_bytes
            snap["serving.journal_lag_records"] = self._journal.lag_records
        if self._spec_on:
            snap["serving.spec_draft_ratio"] = (
                self._spec_accepted / self._spec_drafted
                if self._spec_drafted else 1.0)
            snap["serving.spec_k_live"] = float(np.mean(self._keff))
        return snap

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
        if self.paged and self._spec_provider == "model":
            raise ValueError(
                "prefix sharing is unavailable with a paged draft model: "
                "cached blocks hold target K/V only, and the draft pool "
                "rides the same block tables (use the n-gram provider, or "
                "dense caching)")
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

    def _block_write(self, row, ids, start, pool=None):
        """Row-cache positions [start, start + len(ids) * bs) into blocks
        ``ids`` of ``pool`` (the target's by default), whole blocks, so a
        reused block is overwritten."""
        n, bs = len(ids), self.block_size
        if not n:
            return
        idx = _upload(np.asarray(ids, np.int64), self.device)
        for layer_pool, layer_row in zip(pool or self._pool, row):
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

    def _slot_write(self, slot, row, cache=None):
        """The whole [max_len] row into lane ``slot`` of ``cache`` (the
        target's by default): the full copy is what clears the previous
        occupant's K/V past the new prompt's bucket."""
        for layer_cache, layer_row in zip(cache or self._cache, row):
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
        emitted (it is part of the returned stream). ``priority`` (larger
        is more important) drives preemption under paging: when the pool
        cannot cover this admission, strictly lower-priority lanes are
        evicted onto ``self.preempted`` (their synced tokens kept for
        :meth:`admit_continuation`) until it can. ``key`` is an
        idempotency key: a second admission with the same key returns
        the first one's rid, and once that request has finished, its
        tokens are delivered again by the next step()."""
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if key is not None:
            hit = self._idem.get(key)
            if hit is None and key in self._idem_done:
                rid0, toks0 = self._idem_done[key]
                self._pending_finished[rid0] = list(toks0)
                hit = rid0
            if hit is not None:
                return hit
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        t_p = len(prompt)
        if t_p < 1:
            raise ValueError("empty prompt")
        if t_p + n_new > self.cfg.max_len:
            raise ValueError("prompt+n_new %d exceeds max_len %d"
                             % (t_p + n_new, self.cfg.max_len))
        slot = self._free_slot()
        if slot is None:
            return None
        if self.paged:
            # a paged draft model rides the target's tables, and cached
            # prefix blocks hold target K/V only: it prefills whole
            p_len, hit = ((0, None) if self._spec_provider == "model"
                          else self._lookup_prefix(prompt))
            pfx_blocks, pfx_logits = hit if hit else ([], None)
            lifetime, init_n = self._block_math(t_p, t_p + n_new)
            demand = lifetime - p_len // self.block_size
            if demand > self.num_blocks - 1:
                raise ValueError(
                    "request needs %d KV blocks but the pool has only %d "
                    "usable (num_blocks=%d incl. the null block)"
                    % (demand, self.num_blocks - 1, self.num_blocks))
            if demand > self._alloc.available and not self._evict_prefixes(
                    demand, keep=tuple(prompt[:p_len]) if p_len else None) \
                    and not self._preempt_for(demand, priority):
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
        if self._spec_on:
            self._spec_admit(slot, prompt, t_p, first)
        req = Request(self._next_rid, prompt, n_new, stop_token, seed,
                      priority, key)
        self._next_rid += 1
        req.tokens.append(first)
        req.emitted = 1
        self._slots[slot] = req
        if key is not None:
            self._idem[key] = req.rid
        if self._journal is not None:
            # the submit carries the first token (emitted=1): replay
            # resumes as a continuation from exactly here
            self._journal.append_submit(
                req.rid, req.tokens, n_new, seed=seed,
                stop_token=stop_token, priority=priority, key=key,
                emitted=1)
        return req.rid

    def _free_slot(self):
        return next((i for i, s in enumerate(self._slots) if s is None), None)

    @torch.no_grad()
    def admit_continuation(self, tokens, n_more, seed=0, emitted=1,
                           stop_token=None, priority=0, preempted_ns=None,
                           resumes=None, key=None):
        """Resume a suspended stream: ``tokens`` is its whole synced
        history (prompt + ``emitted`` generated tokens), ``n_more`` the
        budget left. The cache is prefilled again over tokens[:-1] and
        decode resumes feeding the last token at its position; under
        sampling the lane's noise counter starts at ``emitted``, where the
        uninterrupted chain stood (the JAX batcher replays its key chain
        that far), so a preempted and resumed stream equals its
        uninterrupted run, sampled ones included. Returns the new request
        id, or None when no lane or blocks are free. ``key`` carries the
        original idempotency key forward. ``resumes`` names the journaled
        rid this continuation supersedes: with a journal attached it is
        tombstoned (reason ``resume``), so a later replay resumes the new
        record only. ``preempted_ns`` feeds telemetry in the JAX batcher
        and is ignored here."""
        if n_more < 1:
            raise ValueError("n_more must be >= 1")
        if emitted < 1:
            raise ValueError(
                "a continuation resumes a stream that emitted at least its "
                "first token (emitted >= 1)")
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        m = len(tokens) - 1
        if m < 1:
            raise ValueError("continuation needs prompt + first token")
        if len(tokens) + n_more > self.cfg.max_len:
            raise ValueError("history+n_more %d exceeds max_len %d"
                             % (len(tokens) + n_more, self.cfg.max_len))
        slot = self._free_slot()
        if slot is None:
            return None
        if self.paged:
            lifetime, _ = self._block_math(m, len(tokens) + n_more)
            if lifetime > self.num_blocks - 1:
                raise ValueError(
                    "continuation needs %d KV blocks but the pool has only "
                    "%d usable" % (lifetime, self.num_blocks - 1))
            if lifetime > self._alloc.available \
                    and not self._evict_prefixes(lifetime) \
                    and not self._preempt_for(lifetime, priority):
                return None
        req = Request(self._next_rid, tokens, emitted + n_more, stop_token,
                      seed, priority, key)
        req.emitted = emitted
        self._next_rid += 1
        self._resume_lane(slot, req)
        if key is not None:
            self._idem[key] = req.rid
        if self._journal is not None:
            if resumes is not None:
                self._journal.append_finish(resumes, "resume")
            self._journal.append_submit(
                req.rid, req.tokens, req.n_new, seed=seed,
                stop_token=stop_token, priority=priority, key=key,
                emitted=emitted)
        return req.rid

    def _resume_lane(self, slot, req):
        """Put ``req`` into free lane ``slot`` from its token history (the
        continuation identity: the cache holds tokens[:-1], the lane feeds
        tokens[-1] at position len - 1 with noise counter ``emitted``)."""
        ctx, last = req.tokens[:-1], req.tokens[-1]
        m = len(ctx)
        with self._side_stream():
            row = tf.init_cache(self.cfg, 1, self.device)
            padded = np.zeros((1, min(_bucket(m), self.cfg.max_len)),
                              np.int64)
            padded[0, :m] = ctx
            _, row = tf.prefill_chunk(self.params, row, self._tokens(padded),
                                      0, self.cfg, logits_row=m - 1)
        self._join_side(row)
        if self.paged:
            lifetime, init_n = self._block_math(
                m, len(req.tokens) + req.n_new - req.emitted)
            self._paged_map_lane(slot, m, row, 0, [], lifetime, init_n)
        else:
            self._slot_write(slot, row)
        self._set_lane(slot, last, m, req.seed, req.emitted)
        if self._spec_on:
            self._spec_admit(slot, ctx, m, last)
        self._slots[slot] = req

    def _park(self, i):
        """Preempt lane i: its request, tokens synced so far, goes onto
        ``self.preempted`` and its blocks (draft over-allocation included)
        return to the pool; emissions in flight are dropped at their sync
        by the rid snapshot, as cancel() drops them."""
        req = self._slots[i]
        if self._journal is not None:
            self._journal.append_park(req.rid, req.tokens, req.emitted)
        self._free(i)
        self.preempted.append((req, time.perf_counter_ns()))

    def _preempt_for(self, demand, priority):
        """Fund a ``priority`` admission short of ``demand`` available
        blocks by preempting strictly lower-priority lanes, the lowest
        priority first and the youngest (largest rid) within a class.
        True when the demand is covered. An upper bound (every victim's
        whole lifetime) first keeps it from preempting work that could not
        cover the demand anyway."""
        if not self.paged:
            return False
        victims = [i for i, r in enumerate(self._slots)
                   if r is not None and r.priority < priority]
        bound = self._alloc.available \
            + sum(self._lane_need[i] for i in victims)
        if bound < demand:
            return False
        while self._alloc.available < demand:
            live = [(r.priority, -r.rid, i)
                    for i, r in enumerate(self._slots)
                    if r is not None and r.priority < priority]
            if not live:
                break
            self._park(min(live)[2])
        return self._alloc.available >= demand

    # ---- elastic pool ----

    def shrink_pool(self, n):
        """Give back ``n`` blocks of pool capacity, cheapest first: park
        free blocks beyond the admission promises, evict unreferenced
        prefix entries, then preempt the lowest-priority lane (onto
        ``self.preempted``, to resume through admit_continuation).
        Returns the blocks parked (0 when not paged)."""
        if not self.paged:
            return 0
        n = int(n)
        parked = self._alloc.shrink(n)
        while parked < n:
            need = n - parked
            self._evict_prefixes(need)      # best effort; may be partial
            got = self._alloc.shrink(need)
            parked += got
            if got:
                continue
            live = [(r.priority, -r.rid, i)
                    for i, r in enumerate(self._slots) if r is not None]
            if not live:
                break
            self._park(min(live)[2])
        return parked

    def grow_pool(self, n):
        """Return ``n`` blocks of capacity: parked blocks first, then new
        zero blocks appended to the pool (and the draft pool) for the
        rest, whose ids and tables stay valid. Returns the blocks
        returned to circulation."""
        if not self.paged or int(n) <= 0:
            return 0
        n = int(n)
        if _chaos.enabled():
            _chaos.fire("kv.pool.grow", blocks=n)
        got = self._alloc.grow(n)
        rest = n - got
        if rest > 0:
            self._pool = tf.grow_paged_cache(self._pool, rest)
            if self._dpool is not None:
                self._dpool = tf.grow_paged_cache(self._dpool, rest)
            self._alloc.extend(rest)
            self.num_blocks += rest
            got += rest
        return got

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
        grew = req.emitted
        for t in toks[:, i]:
            req.tokens.append(int(t))
            req.emitted += 1
            if req.done:
                break
        self._journal_emit(req, req.emitted - grew)
        return req.done

    def _journal_emit(self, req, grew):
        """The emit record of ``grew`` tokens that just became host-visible
        (read where the sync already read them: it adds no device
        round trip)."""
        if self._journal is not None and grew:
            self._journal.append_emit(
                req.rid, req.tokens[len(req.tokens) - grew:], req.emitted)

    def _finish(self, i, finished):
        """Lane i's request is done: into ``finished``, its key into the
        dedup window, its lane freed."""
        req = self._slots[i]
        finished[req.rid] = list(req.tokens)
        self._note_done(req)
        self._free(i)

    @torch.no_grad()
    def step(self):
        """One scheduling step: ``chunk_size`` ragged decode steps in one
        dispatch. Appends up to chunk_size tokens to every active request
        (a request ending mid-chunk keeps its prefix) and returns {rid:
        full token list} for the requests that finished (their lanes are
        freed). With pipeline_depth > 1 it tops the window up to depth
        dispatches and syncs only the oldest one's emissions: the same
        contract, tokens arriving dispatches later. With spec_k each
        dispatch is chunk_size speculative rounds, up to spec_k + 1 tokens
        a lane a round. A dispatch that raises requeues the live requests
        (see :meth:`_recover_dispatch_failure`)."""
        finished = self._step()
        if self._journal is not None:
            self._journal.maybe_gc()
        return finished

    def _step(self):
        # re-deliveries of finished requests whose key was admitted again
        finished = dict(self._pending_finished)
        self._pending_finished.clear()
        # retire requests complete at admission (n_new=1, or a stop
        # token straight out of the prefill logits)
        for i, req in enumerate(self._slots):
            if req is not None and req.done:
                self._finish(i, finished)
        if self._spec_on:
            return self._step_window(finished, self._dispatch_spec,
                                     self._sync_oldest_spec)
        if self._device_carry:
            return self._step_window(finished, self._dispatch_chunk,
                                     self._sync_oldest)
        if not self.active_count:
            return finished
        k = self.chunk_size
        try:
            if self.paged:
                self._ensure_coverage(k)
            if _chaos.enabled():
                _chaos.fire(self._chaos_site, mode="sync")
            seeds = counters = None
            if not self.greedy:
                seeds = _upload(self._seed, self.device)
                counters = _upload(self._ctr, self.device)
            toks = self._run_chunk(_upload(self._tok, self.device),
                                   _upload(self._pos, self.device), seeds,
                                   counters)[0].cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — requeue or raise
            self._recover_dispatch_failure(exc)
            return finished
        self._dispatch_failures = 0
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
                self._finish(i, finished)
        return finished

    def _step_window(self, finished, dispatch, sync):
        """Top the in-flight window up to pipeline_depth dispatches (the
        classic dispatch-then-sync round trip at depth 1), then sync only
        the oldest."""
        while (len(self._inflight) < self.pipeline_depth
               and self.active_count):
            try:
                dispatch()
            except Exception as exc:  # noqa: BLE001 — requeue or raise
                self._recover_dispatch_failure(exc)
                return finished
        if self._inflight:
            finished.update(sync())
        if not self.active_count:
            # the dispatches still in flight advance parked lanes only
            self._inflight.clear()
        return finished

    def _dispatch_chunk(self):
        """Issue one chunk against the device carry, its emissions copied
        to pinned memory behind an event, and snapshot each lane's
        request id: the identity that decides at sync whose stream the
        emissions belong to."""
        if self.paged:
            self._ensure_coverage(self.chunk_size)
        if _chaos.enabled():
            _chaos.fire(self._chaos_site, mode="pipelined",
                        depth=len(self._inflight) + 1)
        seeds, counters = ((None, None) if self.greedy
                           else (self._dev_seed, self._dev_ctr))
        toks, self._dev_tok, self._dev_pos, counters = self._run_chunk(
            self._dev_tok, self._dev_pos, seeds, counters)
        if counters is not None:
            self._dev_ctr = counters
        self._dispatch_failures = 0
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
                self._finish(i, finished)
        return finished

    # ---- speculative dispatch ----

    def _draft(self, tok, pos, keff):
        """The round's drafts, int32 [B, k] with -1 past each lane's keff:
        n-gram lookup over the lane's stream, or k greedy steps of the
        draft model (decode_step, or decode_step_paged on the target's
        tables) from the lane's current token."""
        k = self.spec_k
        if self._spec_provider == "ngram":
            return _ngram_propose(self._dev_hist, tok, pos, keff, k,
                                  self.spec_ngram)
        seq = []
        for i in range(k):
            if self.paged:
                logits, self._dpool = tf.decode_step_paged(
                    self.draft_params, self._dpool, self._tables, tok,
                    pos + i, self.draft_cfg)
            else:
                logits, self._dcache = tf.decode_step(
                    self.draft_params, self._dcache, tok, pos + i,
                    self.draft_cfg)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            seq.append(tok)
        slot = torch.arange(k, device=tok.device)[None]
        return torch.where(slot < keff[:, None], torch.stack(seq, dim=1), -1)

    def _run_spec_rounds(self, tok, pos, keff):
        """chunk_size speculative rounds on the device: drafts, one verify
        window [tok, d_1..d_k] of every lane, acceptance, the accepted
        targets into the lane's stream history (n-gram), each lane rolled
        forward by its own count. Returns ([rounds, B, k + 2] int32: the
        targets and, last, the emit counts; the next tok and pos)."""
        kk = self.spec_k + 1
        out = []
        for _ in range(self.chunk_size):
            drafts = self._draft(tok, pos, keff)
            window = torch.cat([tok[:, None], drafts.clamp(min=0)], dim=1)
            if self.paged:
                logits, self._pool = tf.verify_chunk_paged(
                    self.params, self._pool, self._tables, window, pos,
                    self.cfg)
            else:
                logits, self._cache = tf.verify_chunk(
                    self.params, self._cache, window, pos, self.cfg)
            target = torch.argmax(logits, dim=-1).to(torch.int32)
            emit, tok = _accept(drafts, target)
            if self._dev_hist is not None:
                # only the accepted prefix of the window enters the
                # history; positions past max_len go to the last column
                hpos = pos.long()[:, None] + 1 \
                    + torch.arange(kk, device=pos.device)[None]
                keep = (torch.arange(kk, device=pos.device)[None]
                        < emit[:, None]) & (hpos < self.cfg.max_len)
                self._dev_hist.scatter_(
                    1, torch.where(keep, hpos, self.cfg.max_len), target)
            pos = pos + emit
            out.append(torch.cat([target, emit[:, None]], dim=1))
        return torch.stack(out), tok, pos

    def _dispatch_spec(self):
        """Issue one speculative dispatch against the device carry. Paged
        coverage is reserved for the worst case, every lane accepting
        every draft every round; the sync walks ``_sched_pos`` back to
        the measured advance and releases the blocks of drafts that were
        rejected (_reconcile_sched_pos)."""
        worst = self.chunk_size * (self.spec_k + 1)
        if self.paged:
            self._ensure_coverage(worst)
        if _chaos.enabled():
            _chaos.fire(self._chaos_site, mode="spec",
                        depth=len(self._inflight) + 1)
        keff_np = np.array(self._keff)
        out, self._dev_tok, self._dev_pos = self._run_spec_rounds(
            self._dev_tok, self._dev_pos, _upload(keff_np, self.device))
        self._dispatch_failures = 0
        self.dispatch_count += 1
        if self.paged:
            self._sched_pos += worst
        buf, event = _fetch_async(out)
        self._inflight.append(
            (buf, event, [r.rid if r is not None else None
                          for r in self._slots], keff_np))

    def _sync_oldest_spec(self):
        """Credit the oldest speculative dispatch's accepted tokens to the
        requests that held each lane at its dispatch, feed each round's
        acceptance into the lane's EWMA and the adaptive k, and reconcile
        the paged accounting down from the worst case."""
        buf, event, lanes, keffs = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        out = buf.numpy()
        targets, emits = out[..., :-1], out[..., -1].astype(np.int64)
        finished = {}
        for i, rid in enumerate(lanes):
            req = self._slots[i]
            if rid is None or req is None or req.rid != rid or req.done:
                continue
            # keff at dispatch: the width these rounds drafted at
            keff_i = max(int(keffs[i]), 1)
            grew0 = req.emitted
            for r in range(emits.shape[0]):
                e = int(emits[r, i])
                self._spec_drafted += keff_i
                self._spec_accepted += e - 1
                self._accept_ewma[i] += _SPEC_EWMA_ALPHA * (
                    (e - 1) / keff_i - self._accept_ewma[i])
                for j in range(e):
                    req.tokens.append(int(targets[r, i, j]))
                    req.emitted += 1
                    if req.done:
                        break
                if req.done:
                    break
            self._journal_emit(req, req.emitted - grew0)
            if self.spec_accept_floor > 0.0:
                # acceptance under the floor narrows the lane's drafts
                # (never below 1), at or above it widens them to spec_k
                if self._accept_ewma[i] < self.spec_accept_floor:
                    self._keff[i] = max(1, int(self._keff[i]) - 1)
                else:
                    self._keff[i] = min(self.spec_k, int(self._keff[i]) + 1)
            if req.done:
                self._finish(i, finished)
        if self.paged:
            self._reconcile_sched_pos(emits, lanes)
        return finished

    def _reconcile_sched_pos(self, emits, lanes):
        """Walk ``_sched_pos`` back from the dispatch's worst case to each
        lane's measured advance and release the blocks it materialised
        for drafts it did not accept. Only lanes whose occupant is the
        one of the dispatch reconcile: a freed or re-admitted lane's
        accounting was reset already."""
        worst = self.chunk_size * (self.spec_k + 1)
        advance = emits.sum(axis=0)
        for i, rid in enumerate(lanes):
            req = self._slots[i]
            if rid is None or req is None or req.rid != rid:
                continue
            self._sched_pos[i] -= worst - int(advance[i])
            self._trim_lane_blocks(i)

    def _trim_lane_blocks(self, i):
        """Release lane i's blocks past its reconciled coverage back into
        reservation (its lifetime need is unchanged). Safe against the
        dispatches in flight: their writes are bounded by the coverage
        kept (their worst case is still in ``_sched_pos``), and a trimmed
        block's positions lie past every query position in flight, so a
        table snapshot can reach it only through masked rows. Trimmed
        blocks have one reference: sharing covers prompt-prefix blocks
        only, which reconciled coverage never drops."""
        bs = self.block_size
        keep = min(max(int(self._sched_pos[i]) - 1, 0) // bs,
                   self._lane_need[i] - 1) + 1
        blocks = self._lane_blocks[i]
        while len(blocks) > max(keep, 1):
            bid = blocks.pop()
            self._tables[i, len(blocks)].fill_(0)
            self._alloc.release([bid])
            self._alloc.reserve(1)

    def _spec_admit(self, slot, ctx, t_p, first):
        """Seed lane ``slot``'s draft state for a stream whose cached
        prefix is the ``t_p`` tokens ``ctx``, with ``first`` its current
        token at position t_p: the n-gram provider's history row, or the
        draft model's prefill over the prefix into its cache or, paged,
        into the lane's blocks of the draft pool (all of them: no
        prefix is shared here). Written on the main stream, after the
        dispatches in flight."""
        if self._spec_provider == "ngram":
            row = np.zeros((self.cfg.max_len + 1,), np.int32)
            row[:t_p] = ctx
            row[t_p] = first
            self._dev_hist[slot].copy_(_upload(row, self.device))
            return
        with self._side_stream():
            drow = tf.init_cache(self.draft_cfg, 1, self.device)
            padded = np.zeros((1, min(_bucket(t_p), self.draft_cfg.max_len)),
                              np.int64)
            padded[0, :t_p] = ctx
            _, drow = tf.prefill_chunk(self.draft_params, drow,
                                       self._tokens(padded), 0,
                                       self.draft_cfg, logits_row=t_p - 1)
        self._join_side(drow)
        if self.paged:
            self._block_write(drow, self._lane_blocks[slot], 0,
                              pool=self._dpool)
        else:
            self._slot_write(slot, drow, cache=self._dcache)

    # ---- dispatch-failure requeue ----

    def _recover_dispatch_failure(self, exc):
        """A dispatch raised. Rebuild the lanes from scratch and requeue
        every live request from its synced tokens: the cache prefilled
        again, decode resuming at the request's position with its noise
        counter where its chain stood, so greedy and sampled streams go
        on as if nothing happened (the JAX batcher reseeds a sampled
        requeue instead; the port's counter-based noise makes the exact
        resume free). Re-raises after ``_max_dispatch_failures``
        consecutive failures, and at once when CUDA reports an error that
        loses the context: nothing can run on it again. A paged dispatch
        that ran out of memory is not a lost context: the pool shrinks
        instead (:meth:`_oom_shrink`) and the lanes stay as they are."""
        self._dispatch_failures += 1
        self.dispatch_failures += 1
        oom = _membudget.is_resource_exhausted(exc)
        if (not oom and _context_lost(self.device)) \
                or self._dispatch_failures > self._max_dispatch_failures:
            raise exc
        if self.paged and oom and self._oom_shrink():
            # memory pressure, not corruption: the next step() retries
            return
        pending = [r for r in self._slots if r is not None]
        self._rebuild_state()
        for req in pending:
            self._resume_lane(self._free_slot(), req)

    def _oom_shrink(self):
        """A dispatch ran out of memory: park part of the pool
        (:meth:`_kv_shrink_blocks`, through ``shrink_pool``, which
        preempts the lowest-priority lanes only when free capacity cannot
        cover it) and let the next step() dispatch again against the
        smaller footprint, instead of rebuilding every lane for what is a
        capacity problem. The injected fault fires before the dispatch
        touches the carry; a real one that persists falls through to the
        rebuild at the next consecutive failure. True when blocks were
        parked."""
        return self.shrink_pool(self._kv_shrink_blocks()) > 0

    def _kv_shrink_blocks(self):
        """Blocks an out-of-memory dispatch parks: a quarter of the usable
        pool (the JAX batcher's default, with
        ``MXNET_MEM_KV_SHRINK_BLOCKS`` unset)."""
        return max((self.num_blocks - 1) // 4, 1)

    def _rebuild_state(self):
        """Every piece of lane state from scratch: slots emptied, the cache
        or the pool and its allocator and tables new (the prefix cache's
        blocks lived in the pool, so a paged prefix cache empties), the
        carry and the draft state zeroed."""
        if self.paged:
            self._prefix_cache.clear()
        self._pool_event = None
        self._init_lanes()

    def reset_lanes(self):
        """Abandon every live request and rebuild the batcher to its
        just-constructed state: a fresh pool, empty lanes, a zero carry,
        the consecutive-failure count and the preempted list cleared
        (``dispatch_failures``, the lifetime count, stays)."""
        self._rebuild_state()
        self._dispatch_failures = 0
        self.preempted = []

    def cancel(self, rid):
        """Evict a request mid-decode; returns the tokens emitted so far
        (under pipelining, synced so far), or None when ``rid`` is not
        active. The other lanes' streams are untouched."""
        for i, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                out = list(req.tokens)
                self._note_done(req, reason="cancel")
                self._free(i)
                return out
        return None

    def _note_done(self, req, reason="finish"):
        """A request left: it gives up its idempotency claim and, when it
        finished, its key enters the dedup window with its tokens; the
        journal gets its tombstone (with the stream when it finished)."""
        if req.key is not None:
            if self._idem.get(req.key) == req.rid:
                self._idem.pop(req.key, None)
            if reason == "finish":
                self._idem_done[req.key] = (req.rid, list(req.tokens))
        if self._journal is not None:
            self._journal.append_finish(
                req.rid, reason,
                tokens=req.tokens if reason == "finish" else None)

    def _free(self, i):
        """Free lane i and park it at position 0 (on an all-null table
        when paged, where its garbage K/V lands in the null block): its
        blocks and the unused tail of its reservation return to the
        allocator, a shared block only with its last reference. Under
        pipelining the park is a patch after the chunks in flight, whose
        writes through the old table are overwritten whole before a
        reused block is read. Under spec_k the lane's adaptive k resets
        (its history row or draft cache is overwritten whole by the next
        admission)."""
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
        if self._spec_on:
            self._keff[i] = self.spec_k
            self._accept_ewma[i] = 1.0

    # ---- durability: crash recovery and weight hot-swap ----

    @torch.no_grad()
    def recover(self):
        """Replay the attached journal after a process crash and re-enter
        every request it recorded.

        Finished requests (a ``finish`` tombstone, or a live record whose
        stream was already complete when the process died) are served
        from their recorded tokens through the next step() and fill the
        idempotency window, so a re-submitted key re-delivers. Live
        requests re-enter as continuations from their journaled synced
        prefix (a sampled one at its noise counter, so it equals its
        uninterrupted run); one the pool cannot hold is parked on
        ``self.preempted``, as a preemption victim, for run() or the
        router to resume. The rid counter moves past every journaled rid.

        Returns ``(resumed, finished, skipped)``: old rid -> new rid (None
        when parked), rid -> final tokens, and the journal's evidence for
        the records it skipped (torn tail, CRC mismatch), each
        ``{"segment", "record", "reason"}``."""
        if self._journal is None:
            raise RuntimeError("recover() needs a journal attached "
                               "(journal=)")
        live, fin, skipped = self._journal.replay()
        # a replayed tombstone for rid N must never end a NEW request
        self._next_rid = max(self._next_rid, self._journal.max_rid + 1)
        done = {}
        for rid, rec in fin.items():
            done[rid] = list(rec["tokens"])
            if rec.get("key") is not None:
                self._idem_done[rec["key"]] = (rid, list(rec["tokens"]))
        resumed = {}
        for rid in sorted(live):
            rec = live[rid]
            toks = list(rec["tokens"])
            emitted = int(rec["emitted"])
            n_more = int(rec["n_new"]) - emitted
            stop = rec["stop"]
            if emitted >= 1 and (n_more <= 0 or (
                    stop is not None and toks and toks[-1] == stop)):
                # the final emission landed before the tombstone did:
                # serve it and write the tombstone now
                done[rid] = list(toks)
                if rec.get("key") is not None:
                    self._idem_done[rec["key"]] = (rid, list(toks))
                self._journal.append_finish(rid, "finish", tokens=toks)
                continue
            if emitted == 0:
                # a router queue record: a fresh admission of the prompt
                new = self.admit(toks, rec["n_new"], seed=rec["seed"],
                                 stop_token=stop, priority=rec["prio"],
                                 key=rec.get("key"))
                if new is not None:
                    self._journal.append_finish(rid, "resume")
                resumed[rid] = new
                continue
            new = self.admit_continuation(
                toks, n_more, seed=rec["seed"], emitted=emitted,
                stop_token=stop, priority=rec["prio"], resumes=rid,
                key=rec.get("key"))
            if new is None:
                # capacity-blocked: parked as a preemption victim (its
                # record stays live, so a second crash still recovers it)
                req = Request(rid, toks, rec["n_new"], stop, rec["seed"],
                              rec["prio"], rec.get("key"))
                req.emitted = emitted
                self.preempted.append((req, time.perf_counter_ns()))
            resumed[rid] = new
        self._pending_finished.update(done)
        return resumed, done, skipped

    @torch.no_grad()
    def swap_weights(self, params, manifest=None):
        """Hot-swap the served weights without dropping a request.

        ``manifest`` gates the swap on the checkpoint lineage: a
        checkpoint directory runs ``checkpoint.verify_lineage`` (the
        newest retained manifest must verify) and reads its
        ``param_fingerprint``; a manifest dict supplies the fingerprint;
        None skips the check (a rollback to weights already served). The
        incoming weights' fingerprint must match, or ``CheckpointCorrupt``
        is raised and the old weights keep serving.

        The swap quiesces at a dispatch boundary: every dispatch in flight
        is synced (its emissions, and the streams it finished, come out
        through the next step()), the lanes and the pool are rebuilt, and
        every live request re-enters from its synced tokens under the new
        weights, as the dispatch-failure requeue does. The prefix cache
        empties (its K/V came from the old weights). Returns
        ``{"fingerprint", "previous", "mode"}``; ``mode`` is always
        ``"resident"`` (the memory budget's drain mode comes with ROADMAP
        item A10)."""
        want = None
        if isinstance(manifest, (str, os.PathLike)):
            chain = _ckpt.verify_lineage(manifest)
            if not chain or chain[0]["status"] != "verified":
                raise _ckpt.CheckpointCorrupt(
                    "swap_weights: lineage of %s does not verify (%s)"
                    % (manifest, chain[0]["status"] if chain
                       else "no manifests"))
            with open(os.path.join(manifest, chain[0]["name"])) as f:
                want = json.load(f).get("param_fingerprint")
        elif isinstance(manifest, dict):
            want = manifest.get("param_fingerprint")
        tf._check_params_device(params, self.device)
        new_fp = params_fingerprint(params)
        if want is not None and new_fp != want:
            raise _ckpt.CheckpointCorrupt(
                "swap_weights: incoming parameter fingerprint %s does not "
                "match manifest %s — refusing unverified weights"
                % (new_fp, want))
        if _chaos.enabled():
            _chaos.fire("serving.swap", fingerprint=new_fp)
        prev_fp = self.weight_fingerprint
        if self._device_carry:
            sync = (self._sync_oldest_spec if self._spec_on
                    else self._sync_oldest)
            while self._inflight:
                self._pending_finished.update(sync())
        pending = [r for r in self._slots if r is not None]
        self.params = params
        self._weight_fp = new_fp
        self._prefix_cache.clear()
        self._rebuild_state()
        for req in pending:
            self._resume_lane(self._free_slot(), req)
        return {"fingerprint": new_fp, "previous": prev_fp,
                "mode": "resident"}

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
        capacity frees. A request preempted by a higher-priority
        admission resumes once capacity frees, after the new admissions
        of that round, and its tokens land under its original rid.
        Returns ({rid: tokens} for all of them, the admission order as a
        list of rids)."""
        queue = list(requests)
        order, results = [], {}
        alias = {}                     # resumed rid -> original rid
        while queue or self.preempted or self.active_count:
            while queue and self.has_capacity:
                rid = self._admit_job(queue[0])
                if rid is None:
                    break
                order.append(rid)
                queue.pop(0)
            # resumed after the new admissions, so a victim cannot take
            # back the blocks its preemptor was owed
            while self.preempted and self.has_capacity:
                req, t_ns = self.preempted[0]
                rid = self.admit_continuation(
                    req.tokens, req.n_new - req.emitted, seed=req.seed,
                    emitted=req.emitted, stop_token=req.stop_token,
                    priority=req.priority, preempted_ns=t_ns,
                    resumes=req.rid, key=req.key)
                if rid is None:
                    if not self.active_count:
                        raise RuntimeError(
                            "preempted request %d cannot resume on an idle "
                            "batcher" % req.rid)
                    break
                self.preempted.pop(0)
                alias[rid] = alias.get(req.rid, req.rid)
            results.update(self.step())
        if alias:
            results = {alias.get(rid, rid): toks
                       for rid, toks in results.items()}
        return results, order

    def stream(self, requests):
        """Streaming driver: yields ``(rid, token, done)`` as each token
        is produced — the first right at admission, then up to
        chunk_size per step per active lane; ``done`` marks a request's
        final token. The same admission policy and streams as run(),
        without its resumption of preempted requests (a streaming caller
        owns its requeue policy). A request cancel()ed between yields
        gets one terminal ``(rid, None, True)`` event."""
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
