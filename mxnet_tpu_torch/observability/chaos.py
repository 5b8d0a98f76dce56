"""Deterministic fault injection (port of
``mxnet_tpu/observability/chaos.py``): the chaos layer the port's
recovery paths are proven against.

Faults are DETERMINISTIC: a rule fires on exact occurrence counts of a
named site, never on a random draw, so a failing chaos test replays
bit for bit. Sites are cheap named checkpoints on the hot paths
(``chaos.fire("serving.dispatch", mode="sync")``) that reduce to one
list check when no rule is installed.

Rules come only from :func:`install` (a spec string) or :func:`inject`
(one rule); the port reads no ``MXNET_CHAOS`` variable. The grammar is
the JAX package's, so both packages' tests drive the same strings::

    spec  := rule (';' rule)*
    rule  := <site-glob> ':' <fault> (':' key '=' value)*
    fault := delay | hang | error | nan | crash | sigterm | bitflip
             | oom

    keys: at=N     fire on the Nth match of this rule (0-based)
          every=N  fire on every Nth match (occ % N == 0)
          count=M  total firings allowed (default 1; 0 = unlimited)
          ms=F     delay/hang duration in milliseconds
                   (delay default 100, hang default 30000)
          rank=R   only on torch.distributed rank R (other ranks do not
                   count occurrences; rank 0 without a process group)
          code=C   exit code for crash (default 13)
          bit=B    bitflip: which bit of the element/byte to flip
          elem=I   bitflip: which element (array sites) or byte
                   (byte/file sites) to corrupt
          bytes=N  oom: the allocation size the injected
                   RESOURCE_EXHAUSTED claims (default 1 GiB)

    from mxnet_tpu_torch.observability import chaos
    chaos.install("journal.append:crash:at=8:code=9")
    chaos.inject("serving.dispatch", "error", at=2)
    ...
    chaos.reset()

Fault semantics at a site: ``delay`` sleeps ``ms``; ``hang`` blocks up
to ``ms`` or until :func:`release`; ``error`` raises :class:`ChaosError`
(an ``OSError``); ``nan`` and ``bitflip`` are returned to the caller,
which corrupts the value it owns (:func:`poison_ndarrays`,
:func:`bitflip_array`, :func:`poison_bitflip`, :func:`corrupt_bytes`,
:func:`corrupt_file`); ``crash`` is ``os._exit(code)`` (no cleanup, no
atexit); ``sigterm`` signals the process itself; ``oom`` raises
:class:`ChaosResourceExhausted`, whose message has the allocator's
RESOURCE_EXHAUSTED grammar, so ``membudget.is_resource_exhausted``
routes it as a real out-of-memory error.

The port's sites, under the JAX package's names: ``journal.append``
(before every journal record, and its at-rest ``corrupt_file`` hook
after the write), ``journal.replay`` (once per segment scanned),
``serving.dispatch`` / ``serving.dispatch.<name>`` (every batcher
dispatch, modes sync, pipelined and spec), ``kv.pool.grow``,
``serving.swap``, ``router.rollout`` (a rollout's swap and canary
phases), ``checkpoint.bytes`` (the landed data file, before the commit),
``checkpoint.write`` (between the data file and the manifests),
``checkpoint.snapshot`` (the host snapshot of a save), ``io.read`` (a
CSV file's read, and each record and each batch of ``ImageRecordIter``
on its Python path) and ``recordio.read`` (each record a RecordIO reader
returns; ``corrupt_bytes`` on its payload).

``stats`` is the always-on view of what fired. The telemetry half of
the JAX module (trace instants and counters, the flight recorder's
incident bundles) comes with the rest of observability, ROADMAP item
A10.

The step guards live here too: :func:`step_guard_enabled` (off unless
:func:`set_step_guard` turns it on; the JAX package reads
``MXNET_STEP_GUARD``), :func:`all_finite` over tensors and
:func:`count_skipped_step`.
"""

import fnmatch
import os
import signal
import threading
import time

import torch

__all__ = ["ChaosError", "ChaosResourceExhausted", "Rule", "enabled",
           "fire", "fire_rules", "parse_spec",
           "inject", "install", "reset", "release", "rules", "stats",
           "poison_ndarrays", "poison_bitflip", "bitflip_array",
           "corrupt_bytes", "corrupt_file",
           "step_guard_enabled", "set_step_guard", "all_finite",
           "count_skipped_step"]

FAULTS = ("delay", "hang", "error", "nan", "crash", "sigterm",
          "bitflip", "oom")

DEFAULT_DELAY_MS = 100.0
DEFAULT_HANG_MS = 30000.0
DEFAULT_CRASH_CODE = 13
DEFAULT_OOM_BYTES = 1 << 30


class ChaosError(OSError):
    """The injected transient failure. Subclasses OSError so retrying
    readers treat it as a real flaky read."""


class ChaosResourceExhausted(RuntimeError):
    """The injected allocation failure. Its message carries the
    RESOURCE_EXHAUSTED status text of an allocator failure, so
    ``membudget.is_resource_exhausted`` routes it as a real
    out-of-memory error."""


class Rule(object):
    """One parsed injection rule. ``seen`` counts matches (after the
    rank filter), ``fired`` counts executions — both are the replayable
    determinism this module is named for."""

    __slots__ = ("pattern", "fault", "at", "every", "count", "ms",
                 "rank", "code", "bit", "elem", "bytes", "seen",
                 "fired")

    def __init__(self, pattern, fault, at=None, every=None, count=1,
                 ms=None, rank=None, code=DEFAULT_CRASH_CODE,
                 bit=0, elem=0, bytes=DEFAULT_OOM_BYTES):
        if fault not in FAULTS:
            raise ValueError("unknown chaos fault %r (one of %s)"
                             % (fault, "/".join(FAULTS)))
        self.pattern = pattern
        self.fault = fault
        self.at = None if at is None else int(at)
        self.every = None if every is None else int(every)
        self.count = int(count)
        self.ms = None if ms is None else float(ms)
        self.rank = None if rank is None else int(rank)
        self.code = int(code)
        self.bit = int(bit)
        self.elem = int(elem)
        self.bytes = int(bytes)
        self.seen = 0
        self.fired = 0

    def __repr__(self):
        return ("Rule(%r, %r, at=%s, every=%s, count=%s, ms=%s, "
                "rank=%s, seen=%d, fired=%d)"
                % (self.pattern, self.fault, self.at, self.every,
                   self.count, self.ms, self.rank, self.seen,
                   self.fired))

    def matches(self, site):
        return fnmatch.fnmatchcase(site, self.pattern)

    def due(self):
        """Called under the lock with ``seen`` NOT yet incremented for
        this occurrence; decides whether this occurrence fires."""
        occ = self.seen
        if self.count and self.fired >= self.count:
            return False
        if self.at is not None:
            return occ == self.at
        if self.every is not None:
            return occ % self.every == 0
        return True


def parse_spec(spec):
    """``site:fault[:k=v]*`` rules joined by ``;`` -> list of Rule."""
    out = []
    for chunk in (spec or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) < 2:
            raise ValueError(
                "chaos rule %r needs at least <site>:<fault>" % chunk)
        kw = {}
        for kv in parts[2:]:
            if "=" not in kv:
                raise ValueError(
                    "chaos rule %r: expected key=value, got %r"
                    % (chunk, kv))
            k, v = kv.split("=", 1)
            if k not in ("at", "every", "count", "ms", "rank", "code",
                         "bit", "elem", "bytes"):
                raise ValueError(
                    "chaos rule %r: unknown key %r" % (chunk, k))
            kw[k] = v
        out.append(Rule(parts[0], parts[1], **kw))
    return out




_lock = threading.Lock()
_prog = []              # installed rules (inject()/install())
_release = threading.Event()
_step_guard = [False]

# always-on cheap counters
stats = {"fired": 0, "skipped_steps": 0}
for _f in FAULTS:
    stats[_f] = 0


def enabled():
    """The site guard: any installed rule."""
    return bool(_prog)


def rules():
    """Snapshot of the active rules (live objects: counters visible)."""
    with _lock:
        return list(_prog)


def _rank():
    """This process's ``torch.distributed`` rank, or 0 without a process
    group."""
    try:
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            return torch.distributed.get_rank()
    except Exception:  # noqa: BLE001 — a rank filter never raises
        pass
    return 0


def fire(site, **info):
    """Run the chaos checkpoint named ``site``. Executes every due
    matching rule's fault and returns the tuple of fault names fired
    (callers act on ``"nan"`` themselves). May sleep, raise
    ChaosError, SIGTERM the process, or _exit — by design."""
    return tuple(r.fault for r in fire_rules(site, **info))


def fire_rules(site, **info):
    """Like :func:`fire`, but returns the fired ``Rule`` objects, for
    sites that read a rule's parameters (``bitflip``'s ``bit=`` and
    ``elem=``)."""
    if not enabled():
        return ()
    due = []
    with _lock:
        rank = None
        for r in _prog:
            if not r.matches(site):
                continue
            if r.rank is not None:
                if rank is None:
                    rank = _rank()
                if r.rank != rank:
                    continue
            if r.due():
                due.append(r)
                r.fired += 1
            r.seen += 1
        for r in due:
            stats["fired"] += 1
            stats[r.fault] += 1
    for r in due:
        _execute(r, site)
    return tuple(due)


def _execute(rule, site):
    if rule.fault == "delay":
        time.sleep((DEFAULT_DELAY_MS if rule.ms is None
                    else rule.ms) / 1e3)
    elif rule.fault == "hang":
        # blocks until release() or the (bounded) hang budget
        _release.wait((DEFAULT_HANG_MS if rule.ms is None
                       else rule.ms) / 1e3)
    elif rule.fault == "error":
        raise ChaosError(
            "chaos: injected fault at site %r (occurrence %d of rule %r)"
            % (site, rule.seen - 1, rule.pattern))
    elif rule.fault == "oom":
        # the allocator's RESOURCE_EXHAUSTED grammar, so text-matching
        # handlers treat the injection as the real thing
        raise ChaosResourceExhausted(
            "RESOURCE_EXHAUSTED: Out of memory while trying to "
            "allocate %d bytes. chaos: injected oom at site %r "
            "(occurrence %d of rule %r)"
            % (rule.bytes, site, rule.seen - 1, rule.pattern))
    elif rule.fault == "crash":
        os._exit(rule.code)          # SIGKILL semantics: no cleanup
    elif rule.fault == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    # "nan" and "bitflip" have no side effect here: the caller owns
    # the value


def release():
    """Unblock every in-flight ``hang`` fault."""
    _release.set()


def inject(site, fault, **kw):
    """Install one rule; returns it (live counters)."""
    r = Rule(site, fault, **kw)
    with _lock:
        _prog.append(r)
    return r


def install(spec):
    """Install a whole spec string (the grammar above)."""
    rs = parse_spec(spec)
    with _lock:
        _prog.extend(rs)
    return rs


def reset():
    """Drop every rule, clear ``stats`` and the hang release latch."""
    with _lock:
        del _prog[:]
        for k in stats:
            stats[k] = 0
    _release.clear()


# ----------------------------------------------------- value poisoning --

def poison_ndarrays(site, arrays, **info):
    """Fire ``site`` and, if a ``nan`` rule was due, overwrite every
    floating NDArray in ``arrays`` with NaN (a gradient gone bad).
    Returns True when poisoned."""
    if not enabled():
        return False
    if "nan" not in fire(site, **info):
        return False
    for a in arrays:
        data = getattr(a, "_data", None)
        if data is None or not data.is_floating_point():
            continue
        a._data = torch.full_like(data, float("nan"))
    return True


_UINT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _flip_in_array(data, bit, elem):
    """One flipped bit in a tensor (a new tensor): viewed as the integer
    type of its width, bit ``bit`` of element ``elem`` (both wrapped into
    range) is xor-ed, every other bit of every element untouched."""
    flat = data.reshape(-1).clone()
    if flat.numel() == 0:
        return data
    width = flat.element_size()
    if width not in _UINT:
        return data
    u = flat.view(_UINT[width])
    idx = int(elem) % flat.numel()
    b = int(bit) % (8 * width)
    # the mask as the signed word of the same bits
    mask = (1 << b) - ((1 << (8 * width)) if b == 8 * width - 1
                       and width > 1 else 0)
    u[idx] ^= mask
    return flat.view(data.dtype).reshape(data.shape)


def bitflip_array(site, arr, **info):
    """Fire ``site``; for every due ``bitflip`` rule, return ``arr`` (a
    tensor) with bit ``rule.bit`` of element ``rule.elem`` flipped, as a
    new tensor. Returns ``arr`` unchanged when nothing fired."""
    if not enabled():
        return arr
    for r in fire_rules(site, **info):
        if r.fault == "bitflip":
            arr = _flip_in_array(arr, r.bit, r.elem)
    return arr


def poison_bitflip(site, arrays, **info):
    """Fire ``site``; for every due ``bitflip`` rule, flip one bit across
    the NDArray list: ``elem`` indexes the concatenation of the arrays'
    flattened elements. Returns True when a flip landed."""
    if not enabled():
        return False
    due = [r for r in fire_rules(site, **info) if r.fault == "bitflip"]
    if not due:
        return False
    arrays = [a for a in arrays if getattr(a, "_data", None) is not None]
    if not arrays:
        return False
    total = sum(int(a._data.numel()) for a in arrays)
    flipped = False
    for r in due:
        idx = r.elem % total if total else 0
        for a in arrays:
            n = int(a._data.numel())
            if idx < n:
                a._data = _flip_in_array(a._data, r.bit, idx)
                flipped = True
                break
            idx -= n
    return flipped


def corrupt_bytes(site, data, **info):
    """Fire ``site``; for every due ``bitflip`` rule, return ``data``
    (bytes) with bit ``rule.bit`` of byte ``rule.elem`` flipped."""
    if not enabled():
        return data
    due = [r for r in fire_rules(site, **info) if r.fault == "bitflip"]
    if not due or not data:
        return data
    ba = bytearray(data)
    for r in due:
        ba[r.elem % len(ba)] ^= 1 << (r.bit % 8)
    return bytes(ba)


def corrupt_file(site, path, **info):
    """Fire ``site``; for every due ``bitflip`` rule, flip one bit of the
    file at ``path`` in place (byte ``rule.elem``, bit ``rule.bit``): an
    at-rest corruption. Returns True when a flip landed."""
    if not enabled():
        return False
    due = [r for r in fire_rules(site, path=str(path), **info)
           if r.fault == "bitflip"]
    if not due:
        return False
    flipped = False
    for r in due:
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if not size:
                    continue
                off = r.elem % size
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ (1 << (r.bit % 8))]))
                flipped = True
        except OSError:
            continue
    return flipped


# --------------------------------------------------------- step guards --

def step_guard_enabled():
    """Whether the non-finite step guard is armed (off by default: the
    check reads one scalar from the device a step)."""
    return _step_guard[0]


def set_step_guard(on=True):
    """Arm (or disarm) the step guard; the JAX package's
    ``MXNET_STEP_GUARD=1``."""
    _step_guard[0] = bool(on)


def all_finite(datas):
    """One finiteness verdict over a list of tensors (floating ones
    checked, integer ones vacuously finite): a single bool read back."""
    ok = None
    for d in datas:
        if d is None:
            continue
        d = torch.as_tensor(d)
        if d.is_floating_point():
            v = torch.isfinite(d).all()
            ok = v if ok is None else ok & v
    return True if ok is None else bool(ok)


def count_skipped_step(where, scaler=None):
    """Bookkeeping for one guarded (skipped) update: ``stats`` and, when
    a loss scaler rides the trainer, its backoff."""
    with _lock:
        stats["skipped_steps"] += 1
    if scaler is not None:
        try:
            scaler.update_scale(True)    # overflow=True: back off
        except Exception:  # noqa: BLE001 — bookkeeping never raises
            pass
