"""Elastic multi-process training: generation rendezvous, shrink, regrow
(port of ``mxnet_tpu/parallel/elastic.py``).

* **generation rendezvous** — every world membership is a numbered
  *generation*. A file sideband (``MXNET_ELASTIC_DIR``) carries the
  generation record, per-rank heartbeats and the shrink and quarantine
  records, each written by an atomic replace. The file names and JSON
  keys are the JAX package's, so either package reads a sideband the
  other wrote. No collective is used for membership: the sideband must
  keep working precisely when a peer has stopped answering collectives.
* **failure detection** — ranks heartbeat (:class:`Heartbeat`, one atomic
  file replace per interval); a peer whose heartbeat is older than
  ``heartbeat_s * miss`` is presumed dead. A watchdog post-mortem file
  (``postmortem.rank<r>.txt``) or a quarantine record counts as evidence
  too.
* **coordinated shrink** — on detection every survivor, re-indexed over
  the sorted survivor set, captures its shard of the training state
  (``models.checkpoint.save_shard_checkpoint``: the replicated weights,
  its slice of the flat optimizer lanes, the data cursor and the RNG),
  writes the generation-(g+1) shrink record and exits with
  :data:`SHRINK_EXIT_CODE` (44). The supervisor
  (``mxnet_tpu_torch.tools.elastic_launch``) relaunches the survivors at
  generation g+1; a recovered host rejoins at the next boundary
  (:data:`BOUNDARY_EXIT_CODE` 45, regrow).
* **exact resume** — ``checkpoint.resume_elastic`` loads the newest
  state, merge-on-load re-partitions the optimizer lanes for any world,
  the cursor restores the iterator mid-epoch (``io`` ``state_dict``), and
  ``keep_global_batch`` compensates a shrunk world with gradient
  accumulation (:func:`make_accum_train_step`).

The capture runs on the monitor thread while the main thread may be
blocked in a collective the dead peer never joins. On the GPU the
training loop records a CUDA event after each completed step and hands
it to the capture with that step's tensors (the provider's ``ready``);
the capture copies them on a stream of its own that waits for that event
only (``checkpoint._local_values``).

The launcher's rendezvous variables are a contract between processes and
stay environment variables: ``MXNET_ELASTIC_DIR``, ``MXNET_TPU_PROC_ID``,
``MXNET_TPU_NUM_PROC``, ``MXNET_ELASTIC_GENERATION`` and
``MXNET_ELASTIC_BASE_WORLD``. The JAX package's knobs are arguments with
its defaults: the heartbeat interval (``interval``, 2 s), the missed
intervals before a verdict (``miss``, 3), ``keep_global_batch`` (off) and
the shard generations kept (``keep_generations``, 2). The JAX module's
telemetry (the ``elastic.*`` counters, gauges and recovery histogram,
flight-recorder incidents) and its watchdog-directory fallback are not
ported; :func:`observe_recovery` returns its milliseconds.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import torch

__all__ = ["SHRINK_EXIT_CODE", "BOUNDARY_EXIT_CODE", "enabled",
           "elastic_dir", "rank_env", "world_env", "generation_env",
           "heartbeat_s", "miss_threshold", "keep_global_batch",
           "accumulation_factor", "read_generation", "write_generation",
           "heartbeat_path", "write_heartbeat", "read_heartbeats",
           "dead_ranks", "shrink_record_path", "write_shrink_record",
           "read_shrink_record", "quarantine_record_path",
           "write_quarantine_record", "read_quarantine_records",
           "quarantined_ranks", "prune_stale", "capture_rng",
           "restore_rng", "jsonable_cursor", "cursor_from_json",
           "Heartbeat", "ElasticCoordinator",
           "install_coordinator", "current_coordinator", "step_boundary",
           "make_accum_train_step", "observe_recovery"]

# the supervisor's exit taxonomy (43 watchdog abort, 46 integrity
# quarantine, 47 structural out-of-memory: tools/elastic_launch.py)
SHRINK_EXIT_CODE = 44        # coordinated shrink: relaunch at g+1, N-k
BOUNDARY_EXIT_CODE = 45      # generation boundary, work remaining (regrow)

DEFAULT_HEARTBEAT_S = 2.0
DEFAULT_MISS = 3


# ------------------------------------------------------- the rendezvous --

def elastic_dir():
    """The rendezvous sideband directory the launcher exported
    (``MXNET_ELASTIC_DIR``), or None."""
    return os.environ.get("MXNET_ELASTIC_DIR") or None


def enabled():
    """Whether a sideband directory is set (the step-boundary guard)."""
    return bool(elastic_dir())


def rank_env():
    """This process's elastic rank (the launcher's process id)."""
    return int(os.environ.get("MXNET_TPU_PROC_ID", "0") or 0)


def world_env():
    return int(os.environ.get("MXNET_TPU_NUM_PROC", "1") or 1)


def generation_env():
    return int(os.environ.get("MXNET_ELASTIC_GENERATION", "0") or 0)


def heartbeat_s(override=None):
    """Seconds between heartbeat writes: ``override``, else JAX's default
    of 2 s."""
    return DEFAULT_HEARTBEAT_S if override is None else float(override)


def miss_threshold(override=None):
    """Missed heartbeat intervals before a peer is presumed dead:
    ``override`` (at least 1), else 3."""
    return DEFAULT_MISS if override is None else max(int(override), 1)


def keep_global_batch(override=None):
    """Whether a shrunk world keeps the global batch by gradient
    accumulation: ``override``, else off (JAX's default)."""
    return bool(override)


def accumulation_factor(base_world, world):
    """Micro-batches a step so ``world`` ranks cover ``base_world`` ranks'
    global batch. Raises when the shrunk world cannot tile the original
    batch evenly: silently changing the effective batch is the fault this
    exists to prevent."""
    base_world, world = int(base_world), int(world)
    if world <= 0 or base_world <= 0:
        raise ValueError("world sizes must be positive (base=%d, now=%d)"
                         % (base_world, world))
    if base_world % world:
        raise ValueError(
            "keep_global_batch: world %d cannot evenly cover the original "
            "world %d's global batch — choose a divisor world size or "
            "restart without compensation" % (world, base_world))
    return base_world // world


# ----------------------------------------------------- sideband records --

def _atomic_write_json(path, obj):
    tmp = os.path.join(os.path.dirname(path),
                       "." + os.path.basename(path) + ".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_generation(d):
    """The current generation record ``{"generation", "world", "ranks",
    ...}`` or None."""
    return _read_json(os.path.join(d, "gen.json"))


def write_generation(d, generation, world, ranks=None, base_world=None,
                     since_wall=None):
    """Commit the generation record (the rendezvous pointer).
    ``since_wall`` stamps when the previous generation's failure was
    detected, so the first worker up can observe the time to recovery."""
    os.makedirs(d, exist_ok=True)
    rec = {"generation": int(generation), "world": int(world),
           "ranks": list(range(world)) if ranks is None else list(ranks),
           "wall": time.time()}
    if base_world is not None:
        rec["base_world"] = int(base_world)
    if since_wall is not None:
        rec["since_wall"] = float(since_wall)
    _atomic_write_json(os.path.join(d, "gen.json"), rec)
    return rec


def heartbeat_path(d, rank, generation):
    return os.path.join(d, "hb.g%d.rank%d.json" % (generation, rank))


def write_heartbeat(d, rank, generation, step=None, wall=None):
    """One atomic heartbeat: the wall time and the last completed step."""
    os.makedirs(d, exist_ok=True)
    _atomic_write_json(heartbeat_path(d, rank, generation),
                       {"rank": int(rank), "generation": int(generation),
                        "step": None if step is None else int(step),
                        "wall": time.time() if wall is None else wall})


def read_heartbeats(d, generation):
    """{rank: record} for every readable heartbeat of ``generation``."""
    out = {}
    try:
        names = os.listdir(d)
    except OSError:
        return out
    prefix = "hb.g%d.rank" % generation
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".json")):
            continue
        rec = _read_json(os.path.join(d, name))
        if rec is not None:
            out[int(rec.get("rank", -1))] = rec
    return out


def _postmortem_ranks(d):
    """Ranks that left a watchdog post-mortem in the sideband: a rank
    wedged in a collective is dead for membership even while its
    heartbeat thread still beats."""
    out = set()
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if name.startswith("postmortem.rank") and name.endswith(".txt"):
            try:
                out.add(int(name[len("postmortem.rank"):-len(".txt")]))
            except ValueError:
                continue
    return out


def dead_ranks(d, generation, world, self_rank, now=None,
               stale_s=None, grace_s=None):
    """Peers presumed dead: a heartbeat older than ``stale_s`` (default
    the default interval times the default miss count), a missing one
    once ``grace_s`` (default ``stale_s``) has passed since the
    generation was committed, a post-mortem, or a quarantine record."""
    now = time.time() if now is None else now
    stale_s = heartbeat_s() * miss_threshold() if stale_s is None \
        else float(stale_s)
    grace_s = stale_s if grace_s is None else float(grace_s)
    beats = read_heartbeats(d, generation)
    gen = read_generation(d) or {}
    gen_wall = float(gen.get("wall", 0.0)) \
        if gen.get("generation") == generation else 0.0
    dead = set()
    for r in range(world):
        if r == self_rank:
            continue
        rec = beats.get(r)
        if rec is None:
            # never checked in: dead only once the start-up grace window,
            # measured from the generation commit, has passed
            if gen_wall and now - gen_wall > grace_s:
                dead.add(r)
            continue
        if now - float(rec.get("wall", 0.0)) > stale_s:
            dead.add(r)
    for r in _postmortem_ranks(d):
        if r != self_rank and r < world:
            dead.add(r)
    # a rank that judged itself corrupt leaves (exit 46) after writing
    # its quarantine record: no need to wait out the staleness window
    for r in quarantined_ranks(d, generation):
        if r != self_rank and 0 <= r < world:
            dead.add(r)
    return dead


def shrink_record_path(d, generation):
    return os.path.join(d, "shrink.g%d.json" % generation)


def write_shrink_record(d, new_generation, survivors, dead, step,
                        base_world=None, wall=None, quarantined=None):
    """The coordinated-shrink record every survivor writes (the same
    content from each; the last replace wins harmlessly): relaunch at
    ``new_generation`` with ``survivors`` as the world, from ``step``.
    ``quarantined`` names dead ranks that were quarantined for
    corruption (no shard was captured)."""
    os.makedirs(d, exist_ok=True)
    rec = {"generation": int(new_generation),
           "survivors": sorted(int(r) for r in survivors),
           "dead": sorted(int(r) for r in dead),
           "world": len(survivors), "step": int(step),
           "wall": time.time() if wall is None else wall}
    if base_world is not None:
        rec["base_world"] = int(base_world)
    if quarantined:
        rec["quarantined"] = sorted(int(r) for r in quarantined)
    _atomic_write_json(shrink_record_path(d, new_generation), rec)
    return rec


def read_shrink_record(d, generation):
    return _read_json(shrink_record_path(d, generation))


def quarantine_record_path(d, generation, rank):
    return os.path.join(d, "quarantine.g%d.rank%d.json"
                        % (generation, rank))


def write_quarantine_record(d, rank, generation, record):
    """The evidence a rank judged corrupt writes before it exits 46:
    survivors read it to skip capturing corrupt-descended state, the
    supervisor for its cooldown list."""
    os.makedirs(d, exist_ok=True)
    _atomic_write_json(quarantine_record_path(d, generation, rank),
                       dict(record, rank=int(rank),
                            generation=int(generation)))


def read_quarantine_records(d, generation=None):
    """All readable quarantine records (of ``generation`` when given),
    as a list of dicts."""
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("quarantine.g") and name.endswith(".json")):
            continue
        rec = _read_json(os.path.join(d, name))
        if rec is None:
            continue
        if generation is not None \
                and int(rec.get("generation", -1)) != int(generation):
            continue
        out.append(rec)
    return out


def quarantined_ranks(d, generation):
    return set(int(r.get("rank", -1))
               for r in read_quarantine_records(d, generation))


def prune_stale(d, generation):
    """Delete the sideband state of generations before ``generation``:
    heartbeats, shrink and quarantine records, and the watchdog check-ins
    and post-mortems older than the generation record. A relaunch must
    never read a dead generation's membership as live. Returns the count
    removed."""
    if not d or not os.path.isdir(d):
        return 0
    removed = 0
    for name in os.listdir(d):
        doomed = False
        for prefix in ("hb.g", "shrink.g", "quarantine.g"):
            if name.startswith(prefix) and name.endswith(".json"):
                try:
                    g = int(name[len(prefix):].split(".")[0])
                except ValueError:
                    continue
                doomed = g < generation
        # watchdog files carry no generation: any written before this
        # generation's record belong to a previous incarnation
        if name.startswith("wd.rank") or name.startswith("postmortem."):
            gen = read_generation(d)
            wall = float((gen or {}).get("wall", 0.0))
            try:
                doomed = wall > 0 and \
                    os.path.getmtime(os.path.join(d, name)) < wall
            except OSError:
                continue
        if doomed:
            try:
                os.remove(os.path.join(d, name))
                removed += 1
            except OSError:
                pass
    return removed


# ------------------------------------------------------------- cursors --

def jsonable_cursor(state):
    """An ``io`` ``state_dict()`` as JSON: numpy arrays become
    ``{"__nd__": dtype, "data": nested lists}``, reversibly."""
    if isinstance(state, np.ndarray):
        return {"__nd__": str(state.dtype), "data": state.tolist()}
    if isinstance(state, np.generic):
        return state.item()
    if isinstance(state, dict):
        return {k: jsonable_cursor(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [jsonable_cursor(v) for v in state]
    return state


def cursor_from_json(state):
    """Inverse of :func:`jsonable_cursor`."""
    if isinstance(state, dict):
        if set(state) == {"__nd__", "data"}:
            return np.asarray(state["data"], dtype=np.dtype(state["__nd__"]))
        return {k: cursor_from_json(v) for k, v in state.items()}
    if isinstance(state, list):
        return [cursor_from_json(v) for v in state]
    return state


# ------------------------------------------------------------------ rng --

def capture_rng(rng=None):
    """JSON-able snapshot of a numpy RandomState (default: numpy's global
    stream, which the shuffling iterators draw from)."""
    state = rng.get_state() if rng is not None else np.random.get_state()
    name, keys, pos, has_gauss, cached = state
    return {"name": str(name), "keys": [int(k) for k in keys],
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def restore_rng(snap, rng=None):
    """Inverse of :func:`capture_rng`."""
    state = (snap["name"], np.asarray(snap["keys"], np.uint32),
             int(snap["pos"]), int(snap["has_gauss"]),
             float(snap["cached"]))
    if rng is not None:
        rng.set_state(state)
        return rng
    np.random.set_state(state)
    return None


# -------------------------------------------------------------- threads --

class Heartbeat(threading.Thread):
    """Daemon heartbeat writer: one atomic file replace per ``interval``
    (default 2 s). ``beat(step)`` from the training loop records the last
    completed step (the shrink record's resume point); its write is
    throttled to half the interval."""

    def __init__(self, d, rank, generation, interval=None):
        super().__init__(name="mxnet-elastic-heartbeat", daemon=True)
        self.dir = d
        self.rank = int(rank)
        self.generation = int(generation)
        self.interval = heartbeat_s(interval)
        self.step = None
        self._stop = threading.Event()
        self._last_write = 0.0
        self.beat()

    def beat(self, step=None):
        if step is not None:
            self.step = int(step)
        now = time.time()
        if now - self._last_write < self.interval / 2.0:
            return
        self._last_write = now
        try:
            write_heartbeat(self.dir, self.rank, self.generation,
                            step=self.step, wall=now)
        except OSError:                 # the sideband is best-effort
            pass

    def run(self):
        while not self._stop.wait(self.interval):
            self._last_write = 0.0      # the thread's beats are never skipped
            self.beat()

    def stop(self):
        self._stop.set()


def _leave(code):
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(code)


class ElasticCoordinator(object):
    """One rank's view of the elastic protocol: heartbeat out, watch the
    peers, and on a detected death run the coordinated shrink — capture
    this survivor's shard of the training state, commit the g+1 shrink
    record, and leave with :data:`SHRINK_EXIT_CODE`.

    ``state()`` returns the provider dict that
    ``models.checkpoint.install_emergency_checkpoint`` takes (``cfg``,
    ``params``, ``momentum``, ``step`` and optionally ``cursor``, ``rng``,
    ``metadata``) for the last COMPLETED step, plus ``ready``: on the GPU
    the CUDA event recorded after that step's kernels. It is called from
    the monitor thread while the main thread may be blocked in a
    collective the dead peer will never join, so its tensors must not be
    written by a later step (:func:`make_accum_train_step` returns new
    ones).

    ``rank``, ``world`` and ``generation`` default to the launcher's
    variables; ``interval`` (2 s), ``miss`` (3) and ``stale_s``
    (``interval * miss``) set the detection; ``keep_generations`` (2) the
    shard sets kept. ``clock``, ``exit`` and ``monitor`` are injectable for
    tests (a fake clock, a captured exit, manual :meth:`check`)."""

    def __init__(self, ckpt_dir, state, d=None, rank=None, world=None,
                 generation=None, base_world=None, clock=time.time,
                 exit=None, monitor=True, interval=None, stale_s=None,
                 miss=None, keep_generations=None):
        self.ckpt_dir = ckpt_dir
        self.state = state
        self.dir = d or elastic_dir()
        if not self.dir:
            raise ValueError("elastic rendezvous needs a sideband directory "
                             "(d=, or MXNET_ELASTIC_DIR from the launcher)")
        self.rank = rank_env() if rank is None else int(rank)
        self.world = world_env() if world is None else int(world)
        self.generation = generation_env() if generation is None \
            else int(generation)
        gen = read_generation(self.dir) or {}
        self.base_world = int(base_world if base_world is not None
                              else gen.get("base_world", self.world))
        self.clock = clock
        self.keep_generations = keep_generations
        self._exit = exit
        self.heartbeat = Heartbeat(self.dir, self.rank, self.generation,
                                   interval=interval)
        self._stale_s = stale_s if stale_s is not None else \
            self.heartbeat.interval * miss_threshold(miss)
        self._monitor = None
        self._shrunk = threading.Event()
        self._claim_lock = threading.Lock()
        self.capture = None          # {"ms", "bytes", "step"} of a shrink
        self._reserved = False
        prune_stale(self.dir, self.generation)
        if monitor:
            self.start()

    def start(self):
        """Start the heartbeat and monitor threads (at construction with
        ``monitor=True``). A world that made the coordinator with
        ``monitor=False`` starts them once every rank has beaten, e.g.
        after a barrier, so that a peer still coming up is not taken for
        a dead one."""
        self.heartbeat.start()
        self._monitor = threading.Thread(
            target=self._watch, name="mxnet-elastic-monitor", daemon=True)
        self._monitor.start()

    # ------------------------------------------------------ membership --
    def beat(self, step=None):
        """The training loop's heartbeat after a completed step. The first
        one also reserves pinned host buffers for the provider's tensors
        (``checkpoint._reserve_host_buffers``), so that a capture made
        while the device is blocked allocates no pinned memory."""
        if not self._reserved:
            self._reserved = True
            from ..models import checkpoint as ckpt
            st = self.state()
            params = st.get("params")
            tensors = [t for _, t in params.named_parameters()] \
                if hasattr(params, "named_parameters") else []
            tensors += list((st.get("momentum") or {}).values())
            ckpt._reserve_host_buffers(tensors)
        self.heartbeat.beat(step)

    def dead(self, now=None):
        return dead_ranks(self.dir, self.generation, self.world,
                          self.rank, now=now, stale_s=self._stale_s)

    def check(self, now=None):
        """One membership check; runs the coordinated shrink when a peer
        died. Returns the dead set (empty when healthy)."""
        if self.world <= 1:
            return set()
        dead = self.dead(now)
        if dead:
            self.shrink(dead)
        return dead

    # ---------------------------------------------------------- shrink --
    def _claim(self):
        """Disarm the shrink; True for the one call that does so first."""
        with self._claim_lock:
            if self._shrunk.is_set():
                return False
            self._shrunk.set()
            return True

    def shrink(self, dead):
        """The survivor-side capture: a shard checkpoint at the NEW world
        size, the shrink record, exit 44. Runs once, whichever of the
        monitor thread and the step boundary detects first, and never
        after :meth:`stop`."""
        if not self._claim():
            return
        survivors = sorted(set(range(self.world)) - set(dead))
        new_rank = survivors.index(self.rank)
        st = self.state()
        step = int(st.get("step", 0))
        quarantined = sorted(set(dead)
                             & quarantined_ranks(self.dir, self.generation))
        print("[elastic] rank %d g%d: peer(s) %s dead — capturing shard "
              "%d/%d at step %d and leaving for generation %d"
              % (self.rank, self.generation, sorted(int(r) for r in dead),
                 new_rank, len(survivors), step, self.generation + 1),
              flush=True)
        from ..models import checkpoint as ckpt
        if quarantined:
            # the survivors' live state may descend from the poisoned
            # all-reduce: no capture; resume restores the last verified
            # checkpoint
            print("[elastic] rank %d g%d: dead peer(s) %s quarantined for "
                  "corruption — skipping shard capture; resume restores "
                  "from the last verified checkpoint"
                  % (self.rank, self.generation, quarantined), flush=True)
        else:
            try:
                t0 = time.perf_counter()
                ckpt.save_shard_checkpoint(
                    self.ckpt_dir, st["cfg"], st["params"],
                    momentum=st.get("momentum"), step=step, rank=new_rank,
                    world=len(survivors), generation=self.generation + 1,
                    cursor=st.get("cursor"), rng=st.get("rng"),
                    base_world=self.base_world,
                    metadata=dict(st.get("metadata") or {},
                                  shrink_from_world=self.world),
                    keep_generations=self.keep_generations,
                    ready=st.get("ready"))
                self.capture = dict(ckpt._last_shard, step=step,
                                    ms=1e3 * (time.perf_counter() - t0))
                print("[elastic] rank %d g%d: shard of step %d committed in "
                      "%.1f ms (host copies %.1f ms, write %.1f ms, %d "
                      "bytes)" % (self.rank, self.generation, step,
                                  self.capture["ms"],
                                  self.capture["capture_ms"],
                                  self.capture["write_ms"],
                                  self.capture["bytes"]), flush=True)
            except Exception:           # last gasp: report, still leave
                import traceback
                traceback.print_exc()
        try:
            write_shrink_record(self.dir, self.generation + 1, survivors,
                                dead, step, base_world=self.base_world,
                                quarantined=quarantined)
        except OSError:
            pass
        self.heartbeat.stop()
        (self._exit or _leave)(SHRINK_EXIT_CODE)

    # -------------------------------------------------------- boundary --
    def leave_at_boundary(self):
        """Clean generation-boundary exit (work remaining): the
        supervisor regrows the world. The caller saves a resumable
        checkpoint first, after :meth:`stop`."""
        self.stop()
        (self._exit or _leave)(BOUNDARY_EXIT_CODE)

    def stop(self):
        """Clean shutdown: ends the heartbeat and the monitor and disarms
        the shrink — a peer that disappears after this rank finished is
        not a failure this rank reacts to. Returns False when a shrink
        had already begun: the shrink then leaves the process, and the
        caller must not go on to finish (its last step may not be the one
        captured)."""
        claimed = self._claim()
        self.heartbeat.stop()
        return claimed

    def wait_for_shrink(self):
        """Block the calling thread while a shrink that has begun on the
        monitor thread captures and leaves the process (with an injected
        ``exit``, return at once)."""
        while self._exit is None:
            time.sleep(1.0)

    def _watch(self):
        poll = max(0.05, self.heartbeat.interval / 2.0)
        while not self._shrunk.is_set():
            time.sleep(poll)
            try:
                self.check()
            except Exception:  # noqa: BLE001 — never take the process down
                pass


# --------------------------------------------------- module coordinator --

_installed = [None]


def install_coordinator(coord):
    """Register the process's coordinator, so step boundaries (the Gluon
    Trainer's, a loop calling :func:`step_boundary`) drive the protocol."""
    _installed[0] = coord
    return coord


def current_coordinator():
    return _installed[0]


_env_beat = [0.0]                      # throttle of the coordinator-less path


def step_boundary(step=None):
    """The per-step hook: heartbeat and membership check when a
    coordinator is installed, else a bare heartbeat from the launcher's
    variables (throttled to half the default interval). One guarded
    branch when no sideband is set."""
    if not enabled():
        return
    coord = _installed[0]
    if coord is not None:
        coord.beat(step)
        coord.check()
        return
    now = time.time()
    if now - _env_beat[0] < heartbeat_s() / 2.0:
        return
    _env_beat[0] = now
    try:
        write_heartbeat(elastic_dir(), rank_env(), generation_env(),
                        step=step)
    except OSError:
        pass


def observe_recovery(generation=None, d=None):
    """Milliseconds since the failure that started this recovery, when
    this worker came up inside one (the shrink record's ``wall``, or the
    generation record's ``since_wall``); None otherwise."""
    d = d or elastic_dir()
    generation = generation_env() if generation is None else generation
    if not d or generation <= 0:
        return None
    since = None
    rec = read_shrink_record(d, generation)
    if rec is not None:
        since = float(rec.get("wall", 0.0)) or None
    gen = read_generation(d)
    if gen is not None and gen.get("generation") == generation:
        since = float(gen.get("since_wall", 0.0)) or since
    if since is None:
        return None
    return max((time.time() - since) * 1e3, 0.0)


# -------------------------------------------- accumulation compensation --

def make_accum_train_step(cfg, mesh=None, lr=1e-2, accum=1, donate=False):
    """``transformer.make_train_step`` with gradient accumulation: the
    step takes tokens ``[accum, B, T]``, averages the ``accum``
    micro-batch gradients and applies ONE update, so a world shrunk by k
    keeps the global batch at k micro-batches a step
    (:func:`accumulation_factor`). Returns ``(params, momentum,
    mean_loss)``.

    The numerics are the JAX step's, whose ``lax.scan`` this loop
    replaces: the gradient sums start at fp32 zeros and add each
    micro-batch's gradient in order; the mean multiplies by ``1/accum``;
    then ``m = 0.9 m + g`` and ``p - lr * m`` in p's dtype, ``lr`` rounded
    to that dtype first; the loss is the sum of the micro-batch losses
    times ``1/accum``. At ``accum=1`` the step is bitwise
    ``make_train_step``'s. Under ``mesh`` every rank passes the global
    tokens and each micro-batch's gradients are summed over dp x sp.

    Without ``donate`` (the default) the inputs survive: new parameters
    (a new TransformerLM) and a new momentum dict come back, so the
    elastic capture can read the last completed step while the next one
    runs. ``donate=True`` writes them in place instead."""
    from ..models import transformer as tf
    from . import bucketed_all_reduce

    accum = int(accum)
    if accum < 1:
        raise ValueError("accum must be >= 1, got %d" % accum)

    def step(params, momentum, tokens):
        if tf._is_q8(params):
            raise ValueError("an int8 weight tree is a serving artifact: "
                             "quantisation discards the weights SGD needs")
        if not torch.is_tensor(tokens):
            tokens = torch.from_numpy(np.asarray(tokens))
        if tokens.dim() != 3 or tokens.shape[0] != accum:
            raise ValueError("tokens must be [accum=%d, B, T], got %s"
                             % (accum, tuple(tokens.shape)))
        names, ps = zip(*params.named_parameters())
        axes = tf._axes(mesh, cfg.dp_axis, cfg.sp_axis)
        g_sum = [torch.zeros(p.shape, dtype=torch.promote_types(
            p.dtype, torch.float32), device=p.device) for p in ps]
        l_sum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        for i in range(accum):
            for p in ps:
                p.requires_grad_(True)
            try:
                loss = tf.loss_fn(params, tokens[i], cfg, mesh)
                grads = torch.autograd.grad(loss, ps)
            finally:
                for p in ps:
                    p.requires_grad_(False)
            with torch.no_grad():
                if axes:
                    grads = bucketed_all_reduce(list(grads)[::-1], axes,
                                                mesh=mesh)[::-1]
                g_sum = [s + g for s, g in zip(g_sum, grads)]
                l_sum = l_sum + loss.detach()
        scale = 1.0 / accum
        new_p, new_m = {}, {}
        with torch.no_grad():
            lrs = {}
            for name, p, g in zip(names, ps, g_sum):
                if p.dtype not in lrs:
                    lrs[p.dtype] = torch.tensor(lr, dtype=p.dtype)
                m = 0.9 * momentum[name] + g * scale
                new_m[name] = m
                new_p[name] = p - lrs[p.dtype] * m.to(p.dtype)
            if donate:
                for name, p in zip(names, ps):
                    momentum[name].copy_(new_m[name])
                    p.copy_(new_p[name])
                return params, momentum, l_sum * scale
        return (tf._rebuild(params, lambda name, leaf: new_p[name]),
                new_m, l_sum * scale)

    return step
