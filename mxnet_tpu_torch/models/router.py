"""SLO-aware request router over N ContinuousBatcher replicas (port of
``mxnet_tpu/models/router.py``, with telemetry off).

* **Routing**: each admission goes to the healthiest replica by its
  ``health_snapshot()``: paged KV headroom
  (``serving.kv_available_blocks``) first, free lanes otherwise, lane
  utilization as the tiebreak.
* **Priorities and deadlines**: ``submit(..., priority=, deadline_ms=)``
  admits by priority class (larger first), oldest first within a class;
  a queued request whose deadline has passed is expired up front
  (``expired_rids``). The JAX router also expires a request whose
  estimated completion overruns its deadline, from its latency
  histograms; those are telemetry (ROADMAP item A10), and with them
  empty the JAX router, like this one, expires on the deadline alone.
* **SLO-aware admission**: a replica whose snapshot reports a
  ``serving.slo_attainment`` below ``slo_floor`` takes no new
  admissions. (The port's batcher reports None, as the JAX batcher does
  before any completion or with telemetry off, so the floor acts only on
  a replica that reports a number.)
* **Shedding**: when no replica can admit and the backlog exceeds
  ``shed_queue``, the lowest-priority newest queued requests are shed
  (``shed_rids``; their result is None).
* **Preemption absorption**: a replica's preempted lanes come back to the
  router queue as continuations at the front of their class and resume
  exactly (greedy and sampled).
* **Failure draining and circuit breakers**: a replica whose ``step()``
  raises (its requeue re-raises after its consecutive-failure cap) is
  drained: its live requests go back to the front of the queue as
  continuations from their synced tokens. Without ``breaker`` the
  replica is dead for good; with it the replica's breaker goes CLOSED ->
  OPEN (capped exponential backoff, counted in router steps) ->
  HALF_OPEN (one canary request routed normally) -> CLOSED, and the
  all-dead re-raise fires only once every breaker is OPEN with its
  retries spent (``breaker_events`` records every transition).
* **Rolling rollout**: ``start_rollout(params, manifest)`` verifies the
  new weights against the checkpoint lineage, then upgrades one replica
  at a time: it drains, swaps (``swap_weights``), and serves a canary
  that must equal solo ``generate()`` under the new weights token for
  token; a divergence, a failed swap or (with ``rollout_attain``) a
  post-swap SLO collapse rolls every upgraded replica back to the prior
  weights, with no stream dropped. Continuations resume only on a
  replica serving the weights their prefix was computed under.
* **Durability**: the router's own journal records its queue;
  ``recover()`` replays it and every replica's journal.

Every knob the JAX router reads from the environment when an argument
is None is an argument here, with the JAX default for the variable
unset: ``shed_queue`` (None), ``slo_floor`` (None), ``breaker`` (off),
``breaker_backoff`` (2), ``breaker_backoff_max`` (32),
``breaker_retries`` (5), ``journal`` (off), ``rollout_attain`` (None),
``rollout_window`` (8) and ``start_rollout``'s ``canary_tokens`` (4).
The device memory gate (``mem.headroom_bytes``), the gauges, events,
flight-recorder context, the per-step mixed-weight-version warning and
the fleet trend detectors are telemetry and the memory budget (ROADMAP
item A10): they do nothing here, as in the JAX router with telemetry
off, and ``fleet_history()`` is empty. ``health_snapshot()`` reports
``router.weight_versions``, and continuations keep to their weights.

    srv = ReplicaRouter.build(params, cfg, n_replicas=2, max_batch=4,
                              paged=True, device="cpu")
    results, order = srv.run(jobs)          # {rid: tokens-or-None}
"""

import json
import os
import time
import warnings
from collections import deque

import numpy as np

from . import checkpoint as _ckpt
from . import journal as _journal
from . import transformer as tf
from .serving import ContinuousBatcher, params_fingerprint
from ..observability import chaos as _chaos

__all__ = ["ReplicaRouter"]

_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}
# rolling-rollout phases, coded for health scrapers
_ROLLOUT_CODE = {"idle": 0, "draining": 1, "canary": 2, "done": 3,
                 "rolled_back": 4}


class _Job(object):
    __slots__ = ("rid", "prompt", "n_new", "seed", "stop_token",
                 "enq_ns", "priority", "deadline_ns", "emitted",
                 "preempt_ns", "key", "fp", "prompt0", "n0")

    def __init__(self, rid, prompt, n_new, seed, stop_token, enq_ns,
                 priority=0, deadline_ns=None, emitted=0,
                 preempt_ns=None, key=None, fp=None, prompt0=None,
                 n0=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.n_new = int(n_new)
        self.seed = int(seed)
        self.stop_token = stop_token
        self.enq_ns = enq_ns
        self.priority = int(priority)
        self.deadline_ns = deadline_ns
        # emitted > 0 marks a CONTINUATION: `prompt` is the whole synced
        # prefix, `n_new` the remaining budget, `seed` the original seed
        self.emitted = int(emitted)
        self.preempt_ns = preempt_ns
        self.key = key                 # idempotency key (dedup window)
        # weight-version affinity: a continuation resumes only on a
        # replica serving the fingerprint its prefix was computed under
        self.fp = fp
        # the ORIGINAL submission (restart-from-origin fallback when
        # affinity cannot be satisfied mid-rollout)
        self.prompt0 = list(prompt0) if prompt0 is not None \
            else list(prompt)
        self.n0 = int(n0) if n0 is not None else int(n_new)


def _open_journal(journal):
    if isinstance(journal, (str, os.PathLike)):
        return _journal.RequestJournal(journal)
    return journal or None


class ReplicaRouter(object):
    """Route a request queue over N ContinuousBatcher replicas (see the
    module docstring for the policy). ``submit()`` enqueues and returns a
    router-level rid, ``step()`` admits, steps every live replica and
    returns ``{rid: tokens}`` for completions (None marks a shed or
    expired request: ``shed_rids``/``expired_rids`` tell them apart),
    ``run(jobs)`` drives a whole workload. Every completed stream equals
    its solo ``generate()``, across re-routing, preemption and breaker
    revival."""

    def __init__(self, replicas, shed_queue=None, slo_floor=None,
                 breaker=None, breaker_backoff=None,
                 breaker_backoff_max=None, breaker_retries=None,
                 journal=None, rollout_attain=None, rollout_window=None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        for i, r in enumerate(self.replicas):
            if r.name is None:
                r.name = "r%d" % i
                r._chaos_site = "serving.dispatch.%s" % r.name
        self._alive = [True] * len(self.replicas)
        self.shed_queue = None if shed_queue is None else int(shed_queue)
        self.slo_floor = None if slo_floor is None else float(slo_floor)
        self.breaker = bool(breaker)
        self._breaker_backoff = max(1, int(
            2 if breaker_backoff is None else breaker_backoff))
        self._breaker_backoff_max = max(self._breaker_backoff, int(
            32 if breaker_backoff_max is None else breaker_backoff_max))
        self._breaker_retries = max(0, int(
            5 if breaker_retries is None else breaker_retries))
        n = len(self.replicas)
        self._brk_state = ["closed"] * n
        self._brk_backoff = [self._breaker_backoff] * n
        self._brk_open_left = [0] * n     # step countdown while OPEN
        self._brk_trips = [0] * n         # consecutive drains
        self._brk_canary = [None] * n     # router rid probing HALF_OPEN
        self.breaker_events = []          # (name, from_state, to_state)
        self._queue = deque()          # _Job, oldest first
        self._next_rid = 0
        # (replica_idx, replica_rid) -> (router_rid, _Job)
        self._live = {}
        self.shed_rids = []
        self.expired_rids = []
        self._last_exc = None
        # the router's own journal covers its QUEUE (the replicas journal
        # their admitted streams): submit() appends an emitted=0 record,
        # admission tombstones it (reason "admit"), a drain or preemption
        # requeue journals the continuation here and tombstones the
        # replica's record (reason "resume")
        self._journal = _open_journal(journal)
        self._idem = {}
        self._idem_done = {}
        self._redeliver = {}     # rid -> tokens, served at next step()
        self._rollout = None
        self.rollout_events = []     # (event, detail) audit trail
        self.rollout_attain = (None if rollout_attain is None
                               else float(rollout_attain))
        self.rollout_window = max(1, int(
            8 if rollout_window is None else rollout_window))

    @classmethod
    def build(cls, params, cfg, n_replicas=2, shed_queue=None,
              slo_floor=None, breaker=None, journal=None, **batcher_kw):
        """n named replicas (r0..rN-1) over shared params, behind one
        router. ``journal`` (a directory) gives the router its journal in
        ``<journal>/router`` and each replica its own in
        ``<journal>/<name>``, the layout of the JAX package's
        ``MXNET_SERVING_JOURNAL_DIR``."""
        reps = [ContinuousBatcher(
            params, cfg, name="r%d" % i,
            journal=(None if journal is None
                     else os.path.join(journal, "r%d" % i)),
            **batcher_kw) for i in range(n_replicas)]
        return cls(reps, shed_queue=shed_queue, slo_floor=slo_floor,
                   breaker=breaker,
                   journal=(None if journal is None
                            else os.path.join(journal, "router")))

    # ---- queueing ----

    @property
    def alive_count(self):
        return sum(self._alive)

    @property
    def active_count(self):
        """Live requests across the fleet (admitted, not finished)."""
        return len(self._live)

    def submit(self, prompt, n_new, seed=0, stop_token=None, priority=0,
               deadline_ms=None, key=None):
        """Enqueue one request; returns its router-level rid. Admission
        happens at the next step(), on whichever replica the policy
        picks: higher ``priority`` first (FIFO within a class); a
        ``deadline_ms`` budget (from now) lets the router expire it up
        front. ``key`` is an idempotency key: a duplicate returns the
        original rid (live: keep waiting on it; finished: the recorded
        result re-delivers at the next step())."""
        if key is not None:
            hit = self._idem.get(key)
            if hit is None and key in self._idem_done:
                rid0, toks0 = self._idem_done[key]
                self._redeliver[rid0] = list(toks0)
                hit = rid0
            if hit is not None:
                return hit
        rid = self._next_rid
        self._next_rid += 1
        ddl = (None if deadline_ms is None
               else time.perf_counter_ns() + int(deadline_ms * 1e6))
        job = _Job(rid, prompt, n_new, seed, stop_token, None,
                   priority=priority, deadline_ns=ddl, key=key)
        self._queue.append(job)
        if key is not None:
            self._idem[key] = rid
        if self._journal is not None:
            # emitted=0: a queue entry, re-enqueued whole by recovery
            # (deadlines are local wall-clock and do not survive)
            self._journal.append_submit(
                rid, job.prompt, n_new, seed=seed, stop_token=stop_token,
                priority=priority, key=key, emitted=0)
        return rid

    # ---- routing policy ----

    def _eligible(self, job=None, ignore_affinity=False):
        """Replicas that may take NEW admissions this round, best headroom
        first: alive, with lane and block capacity, and (with
        ``slo_floor``) attainment at or above the floor. A HALF_OPEN
        replica is eligible only while its canary slot is unclaimed, and
        bypasses the floor. With a ``job`` in hand, a paged replica with a
        free lane but NO block headroom still qualifies, ranked last, when
        it runs strictly lower-priority work that preemption can evict.
        During a rollout the current target takes nothing, and a
        continuation goes only to a replica serving the fingerprint its
        prefix was computed under."""
        scored = []
        ro = self._rollout
        for i, r in enumerate(self.replicas):
            if not self._alive[i]:
                continue
            if ro is not None and ro["phase"] in ("draining", "canary") \
                    and i == ro["idx"]:
                continue           # rollout target: drains, takes none
            if not ignore_affinity and job is not None \
                    and job.emitted > 0 and job.fp is not None \
                    and r.weight_fingerprint != job.fp:
                continue           # would splice two models in a stream
            preempt_only = False
            if not r.has_capacity:
                if job is None or not r.paged \
                        or r.active_count >= r.max_batch \
                        or not any(q is not None
                                   and q.priority < job.priority
                                   for q in r._slots):
                    continue
                preempt_only = True
            half_open = self._brk_state[i] == "half_open"
            if half_open and self._brk_canary[i] is not None:
                continue
            snap = r.health_snapshot()
            att = snap.get("serving.slo_attainment")
            if not half_open and self.slo_floor is not None \
                    and att is not None and att < self.slo_floor:
                continue
            headroom = snap.get("serving.kv_available_blocks")
            if headroom is None:
                headroom = r.max_batch - snap["serving.lane_occupancy"]
            scored.append((preempt_only, -headroom,
                           snap["serving.lane_utilization"], i))
        return [i for _, _, _, i in sorted(scored)]

    def _expire_queued(self, finished):
        """Expire every queued job whose deadline has passed: serving it
        would cost a prefill and a lane for a stream nobody can use."""
        if not any(j.deadline_ns is not None for j in self._queue):
            return
        now = time.perf_counter_ns()
        keep = deque()
        for job in self._queue:
            if job.deadline_ns is None or job.deadline_ns > now:
                keep.append(job)
                continue
            self.expired_rids.append(job.rid)
            finished[job.rid] = None
            self._retire_job(job, "expired")
        self._queue = keep

    def _admit_queued(self, finished):
        self._expire_queued(finished)
        while self._queue:
            # strict priority, FIFO within a class (max() returns the
            # FIRST maximal element)
            job = max(self._queue, key=lambda j: j.priority)
            order = self._eligible(job)
            if not order:
                if job.emitted > 0 and job.fp is not None \
                        and self._eligible(job, ignore_affinity=True):
                    # every replica serving this stream's weights is gone
                    # (mid-rollout): restart from the ORIGINAL prompt so
                    # the whole stream comes from one version
                    job.emitted = 0
                    job.prompt = list(job.prompt0)
                    job.n_new = job.n0
                    job.fp = None
                    continue
                break
            admitted = False
            for i in order:
                rep = self.replicas[i]
                if job.emitted > 0:
                    rep_rid = rep.admit_continuation(
                        job.prompt, job.n_new, seed=job.seed,
                        emitted=job.emitted, stop_token=job.stop_token,
                        priority=job.priority, preempted_ns=job.preempt_ns,
                        key=job.key)
                else:
                    rep_rid = rep.admit(
                        job.prompt, job.n_new, seed=job.seed,
                        stop_token=job.stop_token, enqueued_ns=job.enq_ns,
                        priority=job.priority, key=job.key)
                if rep_rid is not None:
                    self._queue.remove(job)
                    self._live[(i, rep_rid)] = (job.rid, job)
                    if self._journal is not None:
                        # the replica's record owns the stream now
                        self._journal.append_finish(job.rid, "admit")
                    if self.breaker \
                            and self._brk_state[i] == "half_open" \
                            and self._brk_canary[i] is None:
                        self._brk_canary[i] = job.rid
                    if rep.preempted:
                        self._absorb_preempted(i, rep)
                    admitted = True
                    break
            if not admitted:
                break
        # shed the backlog the fleet cannot absorb: lowest priority
        # first, newest within a class
        if self.shed_queue is not None:
            while len(self._queue) > self.shed_queue:
                ix = min(range(len(self._queue)),
                         key=lambda k: (self._queue[k].priority, -k))
                job = self._queue[ix]
                del self._queue[ix]
                self.shed_rids.append(job.rid)
                finished[job.rid] = None
                self._retire_job(job, "shed")

    def _retire_job(self, job, reason):
        """A queued job left the router for good (shed or expired): it
        gives up its idempotency claim and its record is tombstoned."""
        if job.key is not None and self._idem.get(job.key) == job.rid:
            self._idem.pop(job.key, None)
        if self._journal is not None:
            self._journal.append_finish(job.rid, reason)

    def _requeue_cont(self, rep, rep_rid, cont):
        """A stream moved OFF a replica back into the router queue: the
        router's record takes ownership (a submit with the synced prefix)
        and the replica's is tombstoned, so a crash at any point replays
        exactly one of the two."""
        if self._journal is not None:
            self._journal.append_submit(
                cont.rid, cont.prompt, cont.n_new, seed=cont.seed,
                stop_token=cont.stop_token, priority=cont.priority,
                key=cont.key, emitted=cont.emitted)
        if rep._journal is not None:
            rep._journal.append_finish(rep_rid, "resume")

    def _cont(self, rid, job, req, rep, preempt_ns=None):
        """The continuation of ``req`` (synced on ``rep``) for router
        job ``job``."""
        return _Job(rid, req.tokens, req.n_new - req.emitted, job.seed,
                    req.stop_token, job.enq_ns, priority=job.priority,
                    deadline_ns=job.deadline_ns, emitted=req.emitted,
                    preempt_ns=preempt_ns, key=job.key,
                    fp=rep.weight_fingerprint, prompt0=job.prompt0,
                    n0=job.n0)

    def _absorb_preempted(self, i, rep):
        """Replica i preempted lower-priority lanes to cover an admission:
        the victims go to the front of the router queue as continuations
        (priority selection still ranks them below the work that
        displaced them)."""
        conts = []
        for req, t_ns in rep.preempted:
            entry = self._live.pop((i, req.rid), None)
            if entry is None:
                continue               # not routed by us: drop
            rid, job = entry
            cont = self._cont(rid, job, req, rep, preempt_ns=t_ns)
            self._requeue_cont(rep, req.rid, cont)
            conts.append(cont)
        rep.preempted = []
        for cont in reversed(conts):
            self._queue.appendleft(cont)

    def _finish_drained(self, rid, job, req, finished):
        """A drained stream that was complete at that instant."""
        finished[rid] = list(req.tokens)
        if job.key is not None:
            if self._idem.get(job.key) == rid:
                self._idem.pop(job.key, None)
            self._idem_done[job.key] = (rid, list(req.tokens))

    def _drain_replica(self, i, exc, finished):
        """Replica i's dispatch died for good: take it out of rotation and
        put its live requests back at the FRONT of the queue as
        continuations from their synced prefixes, which resume exactly on
        whichever replica picks them up. Without the breaker the replica
        stays dead; with it the breaker opens with capped exponential
        backoff and the replica is rebuilt (``reset_lanes``) ahead of its
        HALF_OPEN canary."""
        self._alive[i] = False
        rep = self.replicas[i]
        drained = []
        for (ri, rep_rid), (rid, job) in sorted(self._live.items()):
            if ri != i:
                continue
            req = next((r for r in rep._slots
                        if r is not None and r.rid == rep_rid), None)
            del self._live[(ri, rep_rid)]
            if req is None:
                continue
            if req.n_new - req.emitted <= 0:
                # complete at the instant of death: nothing to resume
                self._finish_drained(rid, job, req, finished)
                if rep._journal is not None:
                    rep._journal.append_finish(rep_rid, "finish",
                                               tokens=req.tokens)
                continue
            cont = self._cont(rid, job, req, rep)
            self._requeue_cont(rep, rep_rid, cont)
            drained.append(cont)
        for cont in reversed(drained):
            self._queue.appendleft(cont)
        if self.breaker:
            self._brk_trips[i] += 1
            self._brk_canary[i] = None
            if self._brk_trips[i] <= self._breaker_retries:
                try:
                    rep.reset_lanes()
                except Exception:  # noqa: BLE001 — stay broken
                    self._brk_trips[i] = self._breaker_retries + 1
            if self._brk_trips[i] <= self._breaker_retries:
                self._brk_open_left[i] = self._brk_backoff[i]
                self._brk_backoff[i] = min(
                    self._brk_backoff[i] * 2, self._breaker_backoff_max)
            self._transition(i, "open")

    # ---- circuit breaker ----

    def _transition(self, i, state):
        old = self._brk_state[i]
        if old == state:
            return
        self._brk_state[i] = state
        self.breaker_events.append((self.replicas[i].name, old, state))

    def _breaker_tick(self, i):
        """One router step elapsed for an OPEN replica: count the backoff
        down; at zero enter HALF_OPEN, back in rotation for exactly one
        canary admission."""
        if self._brk_state[i] != "open" \
                or self._brk_trips[i] > self._breaker_retries:
            return
        self._brk_open_left[i] -= 1
        if self._brk_open_left[i] <= 0:
            self._brk_canary[i] = None
            self._alive[i] = True
            self._transition(i, "half_open")

    def _breaker_close(self, i):
        """The canary finished: close the breaker and forget the failure
        history."""
        self._brk_trips[i] = 0
        self._brk_backoff[i] = self._breaker_backoff
        self._brk_canary[i] = None
        self._transition(i, "closed")

    # ---- scheduling ----

    def step(self):
        """One fleet round: expire what cannot make its deadline, admit
        what the policy allows, shed what it must, step every live
        replica (draining any that raise, ticking open breakers), and
        return ``{router_rid: tokens}`` for requests that finished (None
        for shed or expired ones). Raises the last replica failure only
        when no replica can make progress again: every one dead (breaker
        off) or every breaker OPEN with its retries spent."""
        finished = {}
        if self._redeliver:
            finished.update(self._redeliver)
            self._redeliver.clear()
        if self._rollout is not None \
                and self._rollout["phase"] == "draining":
            self._rollout_tick(finished)
        self._admit_queued(finished)
        last_exc = None
        for i, rep in enumerate(self.replicas):
            if not self._alive[i]:
                if self.breaker:
                    self._breaker_tick(i)
                continue
            try:
                done = rep.step()
            except Exception as exc:  # noqa: BLE001 — drain or raise
                last_exc = exc
                self._last_exc = exc
                self._drain_replica(i, exc, finished)
                continue
            if rep.preempted:
                self._absorb_preempted(i, rep)
            for rep_rid, toks in done.items():
                if self._rollout is not None \
                        and self._rollout.get("canary") == (i, rep_rid):
                    # the rollout's probe, not client work
                    self._rollout_canary_done(i, toks, finished)
                    continue
                key = (i, rep_rid)
                if key in self._live:
                    rid, job = self._live.pop(key)
                    finished[rid] = toks
                    if job.key is not None:
                        if self._idem.get(job.key) == rid:
                            self._idem.pop(job.key, None)
                        self._idem_done[job.key] = (rid, list(toks))
                    if self.breaker and self._brk_canary[i] == rid:
                        self._breaker_close(i)
        if not any(self._alive):
            exhausted = (not self.breaker) or all(
                t > self._breaker_retries for t in self._brk_trips)
            if exhausted:
                exc = last_exc if last_exc is not None else self._last_exc
                raise exc if exc is not None else RuntimeError(
                    "no live replicas")
        if self._rollout is not None \
                and self._rollout["phase"] == "done" \
                and self._rollout["watch_left"] > 0:
            # post-swap SLO watch: a fleet whose attainment collapses
            # right after an upgrade rolls back even though every canary
            # matched (the canary proves numerics, not load)
            ro = self._rollout
            ro["watch_left"] -= 1
            if self.rollout_attain is not None:
                bad = [r.name for i, r in enumerate(self.replicas)
                       if self._alive[i]
                       and (r.health_snapshot()
                            .get("serving.slo_attainment") or 1.0)
                       < self.rollout_attain]
                if bad:
                    self._rollback_fleet(
                        finished, "post-swap SLO collapse on %s"
                        % ",".join(bad))
        return finished

    # ---- rolling weight rollout ----

    def start_rollout(self, params, manifest=None, canary_tokens=None):
        """Begin a rolling upgrade of the fleet to ``params``, verified
        against the checkpoint lineage BEFORE any replica is touched:
        ``manifest`` is a checkpoint directory (``verify_lineage`` must
        pass and its ``param_fingerprint`` must match the incoming
        weights) or a manifest dict; bad lineage raises
        ``CheckpointCorrupt`` with the fleet untouched.

        step() then upgrades one replica at a time: the target takes no
        admissions, its live streams requeue onto replicas still serving
        their weights, it hot-swaps, and a canary of ``canary_tokens``
        (default 4) tokens must equal solo ``generate()`` under the new
        weights (with the replica's own sampling controls) before the
        next replica starts. A diverged canary, a failed swap or a
        post-swap SLO collapse (``rollout_attain`` over
        ``rollout_window`` steps) rolls every upgraded replica back to
        the prior weights. Returns the target fingerprint."""
        if self._rollout is not None \
                and self._rollout["phase"] in ("draining", "canary"):
            raise RuntimeError("a rollout is already in progress")
        want = None
        if isinstance(manifest, (str, os.PathLike)):
            chain = _ckpt.verify_lineage(manifest)
            if not chain or chain[0]["status"] != "verified":
                raise _ckpt.CheckpointCorrupt(
                    "start_rollout: lineage of %s does not verify (%s)"
                    % (manifest, chain[0]["status"] if chain
                       else "no manifests"))
            with open(os.path.join(manifest, chain[0]["name"])) as f:
                want = json.load(f).get("param_fingerprint")
        elif isinstance(manifest, dict):
            want = manifest.get("param_fingerprint")
        new_fp = params_fingerprint(params)
        if want is not None and new_fp != want:
            raise _ckpt.CheckpointCorrupt(
                "start_rollout: incoming parameter fingerprint %s does not "
                "match manifest %s — refusing unverified weights"
                % (new_fp, want))
        self._rollout = {
            "params": params, "manifest": manifest, "fp": new_fp,
            "prior": [r.params for r in self.replicas],
            "prior_fp": [r.weight_fingerprint for r in self.replicas],
            "phase": "draining", "idx": 0, "canary": None,
            "expected": None,
            "canary_tokens": max(1, 4 if canary_tokens is None
                                 else int(canary_tokens)),
            "watch_left": self.rollout_window,
        }
        self.rollout_events.append(("start", new_fp))
        return new_fp

    @property
    def rollout_phase(self):
        return self._rollout["phase"] if self._rollout else "idle"

    def _rollout_tick(self, finished):
        """One draining round for the current target: requeue its live
        streams and, once it is empty, swap and launch the canary."""
        ro = self._rollout
        i = ro["idx"]
        rep = self.replicas[i]
        if not self._alive[i]:
            # a dead replica has nothing to drain or swap
            self.rollout_events.append(("skipped_dead", rep.name))
            self._rollout_advance()
            return
        self._rollout_drain(i, finished)
        if rep.preempted:
            self._absorb_preempted(i, rep)
        if rep.active_count == 0 and not rep.preempted:
            self._rollout_swap(i, finished)

    def _rollout_drain(self, i, finished):
        """Move the target's live streams back into the router queue as
        continuations from their synced prefixes; the replica stays
        healthy (cancel() frees each lane)."""
        rep = self.replicas[i]
        conts = []
        for (ri, rep_rid), (rid, job) in sorted(self._live.items()):
            if ri != i:
                continue
            req = next((r for r in rep._slots
                        if r is not None and r.rid == rep_rid), None)
            del self._live[(ri, rep_rid)]
            if req is None:
                continue
            if req.n_new - req.emitted <= 0:
                self._finish_drained(rid, job, req, finished)
                if rep._journal is not None:
                    # a crash replays this as finished, not canceled
                    rep._journal.append_finish(rep_rid, "finish",
                                               tokens=req.tokens)
                rep.cancel(rep_rid)
                continue
            cont = self._cont(rid, job, req, rep)
            rep.cancel(rep_rid)    # journal-tombstoned (reason cancel)
            if self._journal is not None:
                self._journal.append_submit(
                    cont.rid, cont.prompt, cont.n_new, seed=cont.seed,
                    stop_token=cont.stop_token, priority=cont.priority,
                    key=cont.key, emitted=cont.emitted)
            conts.append(cont)
        for cont in reversed(conts):
            self._queue.appendleft(cont)

    def _rollout_swap(self, i, finished):
        """The drained target hot-swaps and admits its canary probe. Any
        swap failure rolls the fleet back."""
        ro = self._rollout
        rep = self.replicas[i]
        try:
            if _chaos.enabled():
                _chaos.fire("router.rollout", replica=rep.name,
                            phase="swap")
            rep.swap_weights(ro["params"], manifest=ro["manifest"])
        except Exception as exc:  # noqa: BLE001 — rollback
            self._rollback_fleet(
                finished, "swap failed on %s: %s: %s"
                % (rep.name, type(exc).__name__, exc))
            return
        n_tok = ro["canary_tokens"]
        v = rep.cfg.vocab_size
        prompt = [1 % v, 2 % v, 3 % v]
        greedy, temperature, top_k, top_p = rep._controls
        expected = [int(t) for t in tf.generate(
            rep.params, np.asarray([prompt]), n_tok, rep.cfg,
            greedy=greedy, seed=0, temperature=temperature, top_k=top_k,
            top_p=top_p, device=rep.device)[0].tolist()]
        rep_rid = rep.admit(prompt, n_tok, seed=0)
        if rep_rid is None:
            self._rollback_fleet(
                finished, "canary admission refused on %s" % rep.name)
            return
        ro["canary"] = (i, rep_rid)
        ro["expected"] = expected
        ro["phase"] = "canary"
        self.rollout_events.append(("canary", rep.name))

    def _rollout_canary_done(self, i, toks, finished):
        """The canary finished: equal to solo generate() under the new
        weights closes this replica's upgrade; any divergence (or an
        injected ``router.rollout`` fault, the canary that lies) rolls
        the fleet back."""
        ro = self._rollout
        rep = self.replicas[i]
        # (replica, canary stream, generate()'s) of every canary
        ro.setdefault("canaries", []).append(
            (rep.name, list(toks), list(ro["expected"])))
        try:
            if _chaos.enabled():
                _chaos.fire("router.rollout", replica=rep.name,
                            phase="canary")
            ok = list(toks) == ro["expected"]
        except Exception:  # noqa: BLE001 — divergence
            ok = False
        if not ok:
            self._rollback_fleet(finished, "canary diverged on %s"
                                 % rep.name)
            return
        ro["canary"] = None
        self.rollout_events.append(("upgraded", rep.name))
        self._rollout_advance()

    def _rollout_advance(self):
        ro = self._rollout
        ro["idx"] += 1
        if ro["idx"] >= len(self.replicas):
            ro["phase"] = "done"
            ro["watch_left"] = self.rollout_window
            self.rollout_events.append(("done", ro["fp"]))
        else:
            ro["phase"] = "draining"

    def _rollback_fleet(self, finished, reason):
        """Roll every upgraded replica back to the PRIOR weights (captured
        at start_rollout, so no manifest re-verification). Live streams
        survive the swap; the canary probe is cancelled."""
        ro = self._rollout
        if ro.get("canary") is not None:
            ci, crid = ro["canary"]
            self.replicas[ci].cancel(crid)
            ro["canary"] = None
        for i, rep in enumerate(self.replicas):
            if rep.weight_fingerprint == ro["prior_fp"][i]:
                continue
            try:
                rep.swap_weights(ro["prior"][i])
            except Exception as exc:  # noqa: BLE001 — drain it
                self._drain_replica(i, exc, finished)
        ro["phase"] = "rolled_back"
        ro["reason"] = reason
        self.rollout_events.append(("rolled_back", reason))
        warnings.warn("router: rollout of %s rolled back — %s"
                      % (ro["fp"], reason), RuntimeWarning, stacklevel=2)

    # ---- crash recovery ----

    def recover(self):
        """Replay the router's queue journal and every replica's own
        journal after a whole-process crash. Queue records (submits that
        never reached a replica, and requeued continuations) re-enter the
        router queue; each replica's recovered streams are adopted under
        fresh router rids, its finished streams re-deliver at the next
        step(), and its parked overflow moves into the router queue.
        Returns ``(requeued_rids, finished, skipped)``."""
        if self._journal is None:
            raise RuntimeError("recover() needs a journal attached "
                               "(journal=)")
        live, fin, skipped = self._journal.replay()
        self._next_rid = max(self._next_rid, self._journal.max_rid + 1)
        done = {}
        for rid, rec in fin.items():
            done[rid] = list(rec["tokens"])
            if rec.get("key") is not None:
                self._idem_done[rec["key"]] = (rid, list(rec["tokens"]))
        requeued = []
        for rid in sorted(live):
            rec = live[rid]
            job = _Job(rid, rec["tokens"], rec["n_new"], rec["seed"],
                       rec["stop"], None, priority=rec["prio"],
                       emitted=rec["emitted"], key=rec.get("key"))
            self._queue.append(job)
            if job.key is not None:
                self._idem[job.key] = rid
            requeued.append(rid)
        for i, rep in enumerate(self.replicas):
            if rep._journal is None:
                continue
            # the pre-recovery view maps old rids to their submit
            # records (recover() itself rewrites the journal)
            pre, _pf, _ps = rep._journal.replay()
            resumed, rdone, rskip = rep.recover()
            skipped = skipped + rskip
            for _rep_rid, toks in rdone.items():
                rid = self._next_rid
                self._next_rid += 1
                done[rid] = list(toks)
            for old_rid, new_rid in resumed.items():
                if new_rid is None:
                    continue           # parked; absorbed below
                rec = pre.get(old_rid, {})
                rid = self._next_rid
                self._next_rid += 1
                job = _Job(rid, rec.get("tokens", []),
                           max(int(rec.get("n_new", 0))
                               - int(rec.get("emitted", 1)), 1),
                           rec.get("seed", 0), rec.get("stop"), None,
                           priority=rec.get("prio", 0),
                           emitted=rec.get("emitted", 1),
                           key=rec.get("key"))
                self._live[(i, new_rid)] = (rid, job)
                if job.key is not None:
                    self._idem[job.key] = rid
                requeued.append(rid)
            for req, t_ns in rep.preempted:
                # capacity overflow at replica recovery: the router queue
                # owns it now (journal ownership moves too)
                rid = self._next_rid
                self._next_rid += 1
                cont = _Job(rid, req.tokens, req.n_new - req.emitted,
                            req.seed, req.stop_token, None,
                            priority=req.priority, emitted=req.emitted,
                            key=req.key, preempt_ns=t_ns)
                self._requeue_cont(rep, req.rid, cont)
                self._queue.append(cont)
                if cont.key is not None:
                    self._idem[cont.key] = rid
                requeued.append(rid)
            rep.preempted = []
        self._redeliver.update(done)
        return requeued, done, skipped

    def fleet_history(self, name=None):
        """The fleet's trend rings: empty, as the JAX router's with
        telemetry off (the detectors are ROADMAP item A10)."""
        return [] if name is not None else {}

    def health_snapshot(self):
        """The router's health signals under the JAX router's names: the
        queue and fleet gauges, shed and expired counts, every replica's
        breaker state, the weight versions, the rollout's phase and
        target, and the journal's depth and lag."""
        snap = {
            "router.queue_depth": len(self._queue),
            "router.replicas_alive": self.alive_count,
            "router.active_requests": len(self._live),
            "serving.slo_violation.shed": len(self.shed_rids),
            "serving.slo_violation.expired": len(self.expired_rids),
        }
        for i, r in enumerate(self.replicas):
            snap["router.replica_state.%s" % r.name] = \
                _STATE_CODE[self._brk_state[i]]
        snap["router.weight_versions"] = len(
            {r.weight_fingerprint
             for i, r in enumerate(self.replicas) if self._alive[i]})
        snap["router.rollout_phase"] = _ROLLOUT_CODE[self.rollout_phase]
        if self._rollout is not None:
            snap["router.rollout_target_fp"] = int(self._rollout["fp"], 16)
        if self._journal is not None:
            snap["router.journal_depth_bytes"] = self._journal.depth_bytes
            snap["router.journal_lag_records"] = self._journal.lag_records
        return snap

    def run(self, requests):
        """Serve ``(prompt, n_new[, seed[, stop_token[, priority[,
        deadline_ms]]]])`` jobs through the fleet. Returns ({rid:
        tokens, or None when shed or expired}, submission order)."""
        order = [self.submit(*job) for job in requests]
        results = {}
        while self._queue or self._live or (
                self._rollout is not None
                and self._rollout["phase"] in ("draining", "canary")):
            results.update(self.step())
        return results, order
