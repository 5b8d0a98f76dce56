"""Continuous batching over the paged KV cache (port of the synchronous,
greedy, paged subset of ``mxnet_tpu/models/serving.py``).

A fixed set of lanes decodes as one ragged batch (each lane at its own
position, ``decode_step_paged``); requests are admitted into free lanes
between steps and leave when done. The KV cache is one per-layer block
pool plus a per-lane block table; admission accounts in blocks against
a refcounting free-list allocator, reserving a request's whole lifetime
up front and allocating blocks lazily as its position advances.

Admission prefills the prompt at a power-of-two bucket width (the JAX
package compiles one program per bucket; the port keeps the widths so
both write the same cache rows). Pad rows past the prompt are written
into whole pool blocks and overwritten by decode before attention can
reach them. A freed lane keeps decoding at position 0 through an
all-null table, writing garbage into the null block. RoPE models and
int8 KV pools are served as they are: admission copies every leaf of the
prefilled row cache into whole blocks by name, so an int8 pool's scale
planes follow its codes.

Not ported yet, each raising NotImplementedError: sampling, chunked and
pipelined dispatch, speculative decoding, prefix caching and the
dense-lane (paged=False) batcher. The observability, chaos, journal,
brownout and memory-budget hooks of the JAX batcher have no counterpart.
"""

import numpy as np
import torch

from . import transformer as tf
from ..context import resolve_device

__all__ = ["DEFAULT_KV_BLOCK_SIZE", "BlockAllocator", "Request",
           "ContinuousBatcher"]

DEFAULT_KV_BLOCK_SIZE = 16


def _bucket(n, lo=8):
    b = lo
    while b < n:
        b *= 2
    return b


class BlockAllocator(object):
    """Free-list allocator with per-block refcounts over the paged KV
    pool. Block 0 is the reserved null block (unallocated table entries
    point at it) and is never handed out. A block returns to the free
    list at refcount zero.

    ``reserved`` tracks the worst-case future block demand of admitted
    requests: admission reserves a request's whole lifetime, the lazy
    per-step allocation converts reservation into blocks, and
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
        * ``mappings`` (optional): block-id lists of the live tables —
          each block's refcount equals the number of mappings holding
          it, and no mapped block is free;
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
    __slots__ = ("rid", "tokens", "n_new", "emitted", "stop_token")

    def __init__(self, rid, prompt, n_new, stop_token=None):
        self.rid = rid
        self.tokens = list(prompt)   # prompt + generated so far
        self.n_new = n_new
        self.emitted = 0             # generated count
        self.stop_token = stop_token

    @property
    def done(self):
        """Budget exhausted, or the stop token was emitted (the stop
        token itself is part of the stream)."""
        if self.emitted >= self.n_new:
            return True
        return (self.stop_token is not None and self.emitted > 0
                and self.tokens[-1] == self.stop_token)


class ContinuousBatcher(object):
    """Lane-based continuous batching over the paged ragged decode step.

    >>> srv = ContinuousBatcher(params, cfg, max_batch=8)
    >>> rid = srv.admit([1, 2, 3], n_new=16)      # None when full
    >>> finished = srv.step()                     # {rid: [tokens...]}

    Greedy decoding; a request's stream equals its solo ``generate()``.
    ``params`` is a :class:`~.transformer.TransformerLM` on ``device``
    (the current CUDA device by default; raises when there is none).
    ``block_size`` (default 16) must divide ``cfg.max_len``;
    ``num_blocks`` defaults to a full-context row per lane plus the null
    block."""

    def __init__(self, params, cfg, max_batch=8, greedy=None,
                 temperature=1.0, top_k=None, top_p=None, chunk_size=1,
                 pipeline_depth=1, paged=True, block_size=None,
                 num_blocks=None, spec_k=None, device=None):
        tf._check_supported(cfg)
        if cfg.max_len < 8:
            raise ValueError("max_len too small for the bucket floor")
        tf._check_greedy(greedy, temperature, top_k, top_p)
        for name, value, later in (
                ("chunk_size", chunk_size, "chunked dispatch"),
                ("pipeline_depth", pipeline_depth, "pipelined dispatch")):
            if value < 1:
                raise ValueError("%s must be >= 1" % name)
            if value > 1:
                raise NotImplementedError(
                    "%s=%d: %s arrives with a later slice"
                    % (name, value, later))
        if spec_k is not None:
            raise NotImplementedError(
                "speculative decoding arrives with the speculative-verify "
                "slice")
        if not paged:
            raise NotImplementedError(
                "the dense-lane batcher (paged=False) arrives with a later "
                "slice; this one serves the paged KV cache")
        self.device = resolve_device(device)
        tf._check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.block_size = int(block_size or DEFAULT_KV_BLOCK_SIZE)
        if cfg.max_len % self.block_size:
            raise ValueError("block_size %d must divide max_len %d"
                             % (self.block_size, cfg.max_len))
        self._nb = cfg.max_len // self.block_size          # table width
        if num_blocks is None:
            num_blocks = self.max_batch * self._nb + 1
        self.num_blocks = int(num_blocks)
        self._alloc = BlockAllocator(self.num_blocks)
        self._pool = tf.init_paged_cache(cfg, self.num_blocks,
                                         self.block_size, self.device)
        self._tables = torch.zeros((self.max_batch, self._nb),
                                   dtype=torch.int32, device=self.device)
        self._lane_blocks = [[] for _ in range(self.max_batch)]
        self._lane_need = [0] * self.max_batch
        self._pos = np.zeros((self.max_batch,), np.int32)
        self._tok = np.zeros((self.max_batch,), np.int32)
        self._slots = [None] * self.max_batch   # Request or None
        # decode dispatches issued (one per step() that decoded)
        self.dispatch_count = 0
        self._next_rid = 0

    # ---- admission ----

    @property
    def active_count(self):
        return sum(1 for s in self._slots if s is not None)

    @property
    def has_capacity(self):
        """A free lane and at least one block of unpromised capacity; a
        specific prompt's demand is checked by admit() itself."""
        return (self.active_count < self.max_batch
                and self._alloc.available >= 1)

    @property
    def free_blocks(self):
        """Unallocated pool blocks."""
        return self._alloc.free_blocks

    def cache_prefix(self, tokens):
        raise NotImplementedError(
            "prefix caching arrives with a later slice")

    def check_invariants(self, quiesce=False):
        """Audit the block accounting against every lane's table (see
        BlockAllocator.check_invariants); ``quiesce=True`` also demands
        zero live lanes and a whole free list."""
        self._alloc.check_invariants(
            mappings=[b for b in self._lane_blocks if b], quiesce=quiesce)
        if quiesce and self.active_count:
            raise RuntimeError(
                "quiesce with %d live requests" % self.active_count)
        for i, req in enumerate(self._slots):
            if req is None and (self._lane_blocks[i] or self._lane_need[i]):
                raise RuntimeError("freed lane %d still holds blocks" % i)
        return True

    def _block_math(self, t_p, total_len):
        """(lifetime_blocks, init_blocks) for a request whose final
        stream is ``total_len`` tokens from a ``t_p``-token prompt: the
        deepest cache write of its life is position total_len - 2 (the
        final token is never written), and admission must also cover
        position t_p, the first decode write."""
        last_pos = max(t_p, total_len - 2)
        return (last_pos // self.block_size + 1,
                t_p // self.block_size + 1)

    def _paged_prefill(self, prompt, t_p):
        """Prefill the prompt into a fresh [1, max_len] row cache at its
        bucket width; returns (last-token logits [vocab], row cache)."""
        row_cache = tf.init_cache(self.cfg, 1, self.device)
        width = min(_bucket(t_p), self.cfg.max_len)
        padded = np.zeros((1, width), np.int64)
        padded[0, :t_p] = prompt
        logits, row_cache = tf.prefill_chunk(
            self.params, row_cache, torch.from_numpy(padded).to(self.device),
            0, self.cfg, logits_row=t_p - 1)
        return logits[0], row_cache

    def _paged_map_lane(self, slot, t_p, row_cache, lifetime, init_n):
        """Map a lane's table for a fresh admission: blocks through
        position t_p are allocated and written whole from the row cache,
        the rest of the lifetime is reserved for the lazy per-step
        extension, and unneeded entries stay on the null block."""
        bs = self.block_size
        own = self._alloc.alloc(init_n)
        self._alloc.reserve(lifetime - init_n)
        ids = torch.tensor(own, dtype=torch.long, device=self.device)
        for layer_pool, layer_row in zip(self._pool, row_cache):
            for name, leaf in layer_pool.items():
                rows = layer_row[name][0, :init_n * bs]
                # in place: whole blocks, so a reused block is overwritten
                leaf[ids] = rows.reshape((init_n, bs) + tuple(leaf.shape[2:]))
        trow = np.zeros((self._nb,), np.int32)
        trow[:init_n] = own
        self._tables[slot] = torch.from_numpy(trow).to(self.device)
        self._lane_blocks[slot] = own
        self._lane_need[slot] = lifetime

    def _ensure_coverage(self):
        """Allocate, from the admission reservation, the block the next
        decode position of every live lane writes."""
        bs = self.block_size
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            end = min(int(self._pos[i]) // bs, self._lane_need[i] - 1,
                      self._nb - 1)
            while len(self._lane_blocks[i]) <= end:
                bid = self._alloc.alloc(1)[0]
                self._alloc.unreserve(1)
                self._tables[i, len(self._lane_blocks[i])] = bid
                self._lane_blocks[i].append(bid)

    @torch.no_grad()
    def admit(self, prompt, n_new, stop_token=None):
        """Prefill ``prompt`` into a free lane; returns the request id, or
        None when no lane or not enough unpromised blocks are free. The
        first generated token comes from the prefill logits, so a request
        with n_new=1 never occupies a decode step. ``stop_token`` ends the
        request when emitted (it is part of the returned stream)."""
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
        lifetime, init_n = self._block_math(t_p, t_p + n_new)
        if lifetime > self.num_blocks - 1:
            raise ValueError(
                "request needs %d KV blocks but the pool has only %d "
                "usable (num_blocks=%d incl. the null block)"
                % (lifetime, self.num_blocks - 1, self.num_blocks))
        if lifetime > self._alloc.available:
            return None
        last, row_cache = self._paged_prefill(prompt, t_p)
        self._paged_map_lane(slot, t_p, row_cache, lifetime, init_n)
        # torch.argmax takes the first maximum, as np.argmax does
        first = int(torch.argmax(last))
        self._pos[slot] = t_p          # next decode writes position t_p
        self._tok[slot] = first
        req = Request(self._next_rid, prompt, n_new, stop_token)
        self._next_rid += 1
        req.tokens.append(first)
        req.emitted = 1
        self._slots[slot] = req
        return req.rid

    # ---- decode ----

    @torch.no_grad()
    def step(self):
        """One ragged decode step over all lanes. Appends a token to
        every active request; returns {rid: full token list} for the
        requests that finished (their lanes are freed)."""
        finished = {}
        # retire requests complete at admission (n_new=1, or a stop
        # token straight out of the prefill logits)
        for i, req in enumerate(self._slots):
            if req is not None and req.done:
                finished[req.rid] = list(req.tokens)
                self._free(i)
        if not any(s is not None for s in self._slots):
            return finished
        self._ensure_coverage()
        logits, self._pool = tf.decode_step_paged(
            self.params, self._pool, self._tables,
            torch.from_numpy(self._tok).to(self.device),
            torch.from_numpy(self._pos).to(self.device), self.cfg)
        toks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.dispatch_count += 1
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            req.tokens.append(int(toks[i]))
            req.emitted += 1
            self._pos[i] += 1
            self._tok[i] = toks[i]
            if req.done:
                finished[req.rid] = list(req.tokens)
                self._free(i)
        return finished

    def _free(self, i):
        """Free lane i: return its blocks and the unused tail of its
        reservation, and park it at position 0 on an all-null table,
        where its garbage K/V lands in the null block."""
        self._slots[i] = None
        blocks = self._lane_blocks[i]
        self._alloc.release(blocks)
        self._alloc.unreserve(self._lane_need[i] - len(blocks))
        self._lane_blocks[i] = []
        self._lane_need[i] = 0
        self._tables[i] = 0
        self._pos[i] = 0
        self._tok[i] = 0

    def run(self, requests):
        """Serve ``requests`` (an iterable of (prompt, n_new[,
        stop_token])) through the lanes, admitting as capacity frees.
        Returns ({rid: tokens} for all of them, the admission order as a
        list of rids)."""
        queue = list(requests)
        order, results = [], {}
        while queue or self.active_count:
            while queue and self.has_capacity:
                job = queue[0]
                rid = self.admit(job[0], job[1],
                                 stop_token=job[2] if len(job) > 2 else None)
                if rid is None:
                    break
                order.append(rid)
                queue.pop(0)
            results.update(self.step())
        return results, order
