"""Request write-ahead journal (port of ``mxnet_tpu/models/journal.py``):
durable serving across process death. The format on disk is the JAX
package's, byte for byte: a journal written by either package replays
identically in the other.

Every serving-visible state change of a request appends ONE CRC-guarded
record to a segment file under the journal's directory:

* ``submit`` — admission (or router enqueue): rid, the full token
  prefix (prompt, plus the first generated token for batcher-level
  records — admit() produces it from the prefill logits), remaining
  budget, sampling seed, stop token, priority, deadline, idempotency
  key, and the cumulative ``emitted`` count (>= 1 marks a
  continuation; a sampled stream's noise counter stands at ``emitted``,
  so recording the count records the sampler's state).
* ``emit`` — a chunk-sync checkpoint: the tokens that just became
  host-visible plus the new cumulative count. These ride the existing
  per-chunk host sync (the batcher already pulled the tokens); the
  journal adds no device round trip.
* ``park`` — a preemption: the victim's synced prefix and count, so a
  crash before its resume replays it as a live continuation.
* ``fin`` — a tombstone: finish / cancel / shed / expire / resume,
  with the final token stream for ``finish`` (the idempotent-dedup
  serving copy).

A record is one line, ``"%08x %s\\n" % (crc32(json), json)`` — the
checkpoint manifest's CRC idiom — written with one ``os.write`` on an
``O_APPEND`` descriptor (atomic for line-sized writes on a local
filesystem). A torn tail (no trailing newline, a short line) or a
CRC-mismatched record is SKIPPED at replay with named evidence
(segment, record index, reason): one bad record never poisons the
stream behind it.

Segments rotate at ``segment_bytes`` and a prefix-truncating GC removes
the longest head run of segments whose every request is tombstoned AND
touches no surviving segment — so a live request's records (including
its submit in an old segment) are never truncated. ``replay()``
reconstructs ``(live, finished, skipped)`` for
``ContinuousBatcher.recover()`` / ``ReplicaRouter.recover()``.

Durability knobs are arguments (the port reads no environment):
``segment_bytes`` (rotation threshold, default 1 MiB, the JAX package's
with ``MXNET_SERVING_JOURNAL_SEGMENT_BYTES`` unset) and ``fsync``
(fsync every append; default off, as with ``MXNET_SERVING_JOURNAL_FSYNC``
unset — the journal then survives process death, which is the serving
failure mode, but not host power loss).

Chaos sites: ``journal.append`` fires before every record write (so
``journal.append:crash:at=K:code=9`` kills the process with record K
torn away — the kill -9 replay test) and supports ``bitflip`` at-rest
corruption via ``chaos.corrupt_file``; ``journal.replay`` fires once
per replayed segment.
"""

import json
import os
import zlib

from ..observability import chaos as _chaos

__all__ = ["RequestJournal"]

DEFAULT_SEGMENT_BYTES = 1 << 20
_SEG_FMT = "seg-%06d.wal"


def _crc_line(payload):
    """``payload`` (bytes) -> the full journal line (bytes)."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"%08x " % crc + payload + b"\n"


class RequestJournal(object):
    """Segmented request write-ahead log (see the module docstring).

    >>> j = RequestJournal(dirpath)
    >>> j.append_submit(rid, tokens, n_new, seed, stop, priority)
    >>> j.append_emit(rid, new_tokens, emitted)
    >>> j.append_finish(rid, "finish", tokens=stream)
    >>> live, finished, skipped = RequestJournal(dirpath).replay()

    Construction scans every existing segment once (the replay pass),
    then opens a FRESH segment for appends — a recovering process never
    writes into its predecessor's tail.
    """

    def __init__(self, dirpath, segment_bytes=None, fsync=False):
        if not dirpath:
            raise ValueError("RequestJournal needs a directory")
        self.dir = str(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        if segment_bytes is None:
            segment_bytes = DEFAULT_SEGMENT_BYTES
        self.segment_bytes = max(1, int(segment_bytes))
        self.fsync = bool(fsync)
        # per-segment bookkeeping (insertion order == name order):
        # which rids each segment touches, how many valid records and
        # bytes it holds — what GC and the depth/lag gauges read
        self._seg_rids = {}         # seg name -> set(rid)
        self._seg_records = {}      # seg name -> valid record count
        self._seg_bytes = {}        # seg name -> file size
        self._done = set()          # tombstoned rids
        self._max_rid = -1
        self._live, self._finished, self._skipped = {}, {}, {}
        self._scan()
        nxt = 0
        for name in self._seg_rids:
            nxt = max(nxt, int(name[4:-4]) + 1)
        self._next_seg = nxt
        self._fd = None
        self._active = None
        self._active_bytes = 0
        self._rotated = False       # a rotation since the last gc()

    # ---- append path ----

    def _open_segment(self):
        if self._fd is not None:
            os.close(self._fd)
        name = _SEG_FMT % self._next_seg
        self._next_seg += 1
        self._fd = os.open(os.path.join(self.dir, name),
                           os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                           0o644)
        self._active = name
        self._active_bytes = 0
        self._seg_rids[name] = set()
        self._seg_records[name] = 0
        self._seg_bytes[name] = 0

    def _append(self, obj):
        rid = obj["rid"]
        if _chaos.enabled():
            # fires BEFORE the write: a crash rule tears this record
            # away, a delay rule stalls the append, an error rule
            # surfaces as an OSError to the caller's one guarded site
            _chaos.fire("journal.append", type=obj["t"], rid=rid)
        line = _crc_line(json.dumps(obj, separators=(",", ":"),
                                    sort_keys=True).encode())
        if self._fd is None \
                or self._active_bytes >= self.segment_bytes:
            if self._fd is not None:
                self._rotated = True
            self._open_segment()
        os.write(self._fd, line)
        if self.fsync:
            os.fsync(self._fd)
        if _chaos.enabled():
            # at-rest corruption: a journal.append bitflip rule flips
            # one bit of the segment file, replayably
            _chaos.corrupt_file("journal.append",
                                os.path.join(self.dir, self._active))
        self._active_bytes += len(line)
        self._seg_bytes[self._active] += len(line)
        self._seg_records[self._active] += 1
        self._seg_rids[self._active].add(rid)
        self._max_rid = max(self._max_rid, rid)
        self._apply(obj)

    def append_submit(self, rid, tokens, n_new, seed=0, stop_token=None,
                      priority=0, key=None, emitted=0,
                      deadline_ms=None):
        rec = {"t": "submit", "rid": int(rid),
               "tokens": [int(t) for t in tokens], "n_new": int(n_new),
               "seed": int(seed), "stop": stop_token,
               "prio": int(priority), "emitted": int(emitted)}
        if key is not None:
            rec["key"] = key
        if deadline_ms is not None:
            rec["deadline_ms"] = float(deadline_ms)
        self._append(rec)

    def append_emit(self, rid, tokens, emitted):
        self._append({"t": "emit", "rid": int(rid),
                      "tokens": [int(t) for t in tokens],
                      "emitted": int(emitted)})

    def append_park(self, rid, tokens, emitted):
        self._append({"t": "park", "rid": int(rid),
                      "tokens": [int(t) for t in tokens],
                      "emitted": int(emitted)})

    def append_finish(self, rid, reason, tokens=None):
        rec = {"t": "fin", "rid": int(rid), "reason": reason}
        if tokens is not None and reason == "finish":
            rec["tokens"] = [int(t) for t in tokens]
        self._append(rec)

    # ---- replay ----

    def _apply(self, obj):
        """Fold one record into the (live, finished) reconstruction."""
        rid = obj["rid"]
        t = obj["t"]
        if t == "submit":
            self._live[rid] = {
                "tokens": list(obj["tokens"]), "n_new": obj["n_new"],
                "seed": obj.get("seed", 0), "stop": obj.get("stop"),
                "prio": obj.get("prio", 0), "key": obj.get("key"),
                "emitted": obj.get("emitted", 0),
                "deadline_ms": obj.get("deadline_ms")}
            return True
        if rid not in self._live:
            return False               # emit/park/fin for unknown rid
        if t == "emit":
            rec = self._live[rid]
            rec["tokens"].extend(obj["tokens"])
            rec["emitted"] = obj["emitted"]
        elif t == "park":
            rec = self._live[rid]
            rec["tokens"] = list(obj["tokens"])
            rec["emitted"] = obj["emitted"]
        elif t == "fin":
            rec = self._live.pop(rid)
            self._done.add(rid)
            if obj.get("reason") == "finish":
                self._finished[rid] = {
                    "tokens": obj.get("tokens", rec["tokens"]),
                    "reason": "finish", "key": rec.get("key")}
        return True

    def _scan(self):
        """One pass over the existing segments: rebuild the per-segment
        rid/record maps AND the (live, finished, skipped) replay state.
        Torn or CRC-corrupt records are skipped with named evidence."""
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("seg-") and n.endswith(".wal"))
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                self._skip(name, -1, "unreadable segment: %s" % e)
                continue
            if _chaos.enabled():
                _chaos.fire("journal.replay", segment=name)
            self._seg_rids[name] = set()
            self._seg_records[name] = 0
            self._seg_bytes[name] = len(data)
            tail_torn = not data.endswith(b"\n")
            lines = data.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
            for idx, line in enumerate(lines):
                if tail_torn and idx == len(lines) - 1:
                    self._skip(name, idx,
                               "torn tail (no record terminator)")
                    continue
                obj = self._parse(name, idx, line)
                if obj is None:
                    continue
                self._seg_records[name] += 1
                self._seg_rids[name].add(obj["rid"])
                self._max_rid = max(self._max_rid, obj["rid"])
                if not self._apply(obj):
                    self._skip(name, idx,
                               "%s record for unknown rid %d"
                               % (obj["t"], obj["rid"]))

    def _parse(self, name, idx, line):
        if len(line) < 10 or line[8:9] != b" ":
            self._skip(name, idx, "malformed record framing")
            return None
        want, payload = line[:8], line[9:]
        got = b"%08x" % (zlib.crc32(payload) & 0xFFFFFFFF)
        if got != want:
            self._skip(name, idx, "crc mismatch (%s != %s)"
                       % (got.decode(), want.decode()))
            return None
        try:
            obj = json.loads(payload.decode())
            if not isinstance(obj, dict) or "t" not in obj \
                    or "rid" not in obj:
                raise ValueError("not a journal record")
            obj["rid"] = int(obj["rid"])
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            self._skip(name, idx, "undecodable payload: %s" % e)
            return None
        return obj

    def _skip(self, name, idx, reason):
        self._skipped.setdefault("evidence", []).append(
            {"segment": name, "record": idx, "reason": reason})

    def replay(self):
        """The reconstructed state: ``(live, finished, skipped)``.
        ``live`` maps rid -> {tokens, n_new, seed, stop, prio, key,
        emitted, deadline_ms} (everything ``admit_continuation`` /
        re-enqueue needs), ``finished`` maps rid -> {tokens, reason,
        key} (the idempotent-dedup serving copies), ``skipped`` is the
        named evidence list for records the scan refused."""
        live = {rid: dict(rec, tokens=list(rec["tokens"]))
                for rid, rec in self._live.items()}
        fin = {rid: dict(rec, tokens=list(rec["tokens"]))
               for rid, rec in self._finished.items()}
        return live, fin, list(self._skipped.get("evidence", []))

    @property
    def max_rid(self):
        """Largest rid any record names (-1 when empty) — a recovering
        batcher bumps its rid counter past it so resumed and fresh
        requests never collide in the same journal."""
        return self._max_rid

    # ---- size / GC ----

    @property
    def depth_bytes(self):
        """Bytes across all surviving segments (the
        ``serving.journal_depth_bytes`` gauge)."""
        return sum(self._seg_bytes.values())

    @property
    def lag_records(self):
        """Valid records a replay would have to read (the
        ``serving.journal_lag_records`` gauge) — GC is what keeps this
        bounded."""
        return sum(self._seg_records.values())

    def gc(self):
        """Prefix-truncating segment GC: remove the longest HEAD run of
        segments in which every request is tombstoned and none touches
        a surviving segment (so no surviving record ever references a
        truncated rid — a live request's segment is never collected,
        and neither is a finished one whose tombstone lives further
        down the log). Returns the removed segment names."""
        names = sorted(self._seg_rids)
        cut, seen = 0, set()
        for k, name in enumerate(names):
            if name == self._active:
                break
            seen |= self._seg_rids[name]
            if not seen <= self._done:
                break
            rest = set()
            for later in names[k + 1:]:
                rest |= self._seg_rids[later]
            if seen & rest:
                continue            # a rid here survives further down
            cut = k + 1
        removed = names[:cut]
        for name in removed:
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass                # a lost unlink only delays the GC
            for rid in self._seg_rids[name]:
                self._finished.pop(rid, None)
            self._done -= self._seg_rids[name]
            del self._seg_rids[name]
            del self._seg_records[name]
            del self._seg_bytes[name]
        return removed

    def maybe_gc(self):
        """GC iff a segment rotated since the last collection — the
        cheap per-round tick the batcher calls from ``_end_round``."""
        if not self._rotated:
            return []
        self._rotated = False
        return self.gc()

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
