"""The port's request journal (``mxnet_tpu_torch/models/journal.py``) held
against the JAX package's ``RequestJournal``: the round trip, torn and
CRC-failed records skipped with named evidence, GC that spares live
segments, the chaos sites, and the bytes on disk: the same records give
byte-identical segments in both packages, and a journal written by
either replays in the other to the same ``(live, finished, skipped)``,
``max_rid``, ``depth_bytes`` and ``lag_records``. Tolerance: exact."""

import os

import pytest

from mxnet_tpu.models.journal import RequestJournal as JJournal
from mxnet_tpu.observability import chaos as jchaos

from mxnet_tpu_torch.models.journal import RequestJournal
from mxnet_tpu_torch.observability import chaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _segs(d):
    return sorted(n for n in os.listdir(str(d)) if n.endswith(".wal"))


def _write(cls, d, segment_bytes=None):
    """One scripted history: submits (with keys, deadlines, a stop token),
    emits, a park, a cancel, finishes and a resume."""
    j = cls(str(d), segment_bytes=segment_bytes)
    j.append_submit(0, [1, 2, 3, 9], 6, seed=4, stop_token=7, priority=2,
                    key="a", emitted=1)
    j.append_submit(1, [5, 6], 4, seed=1, emitted=1, deadline_ms=250.5)
    j.append_emit(0, [8, 2], 3)
    j.append_park(1, [5, 6, 3], 2)
    j.append_submit(2, [7], 3, emitted=1)
    j.append_finish(2, "finish", tokens=[7, 1, 2, 3])
    j.append_submit(3, [4, 4], 5, emitted=0, key="q")
    j.append_finish(3, "cancel", tokens=[4, 4, 1])
    j.append_finish(1, "resume")
    j.append_submit(4, [5, 6, 3], 4, seed=1, emitted=2)
    j.append_emit(4, [11], 3)
    j.close()
    return j


def _state(j):
    return j.replay(), j.max_rid, j.depth_bytes, j.lag_records


def test_roundtrip():
    """submit/emit/park/finish fold back into the live and finished state
    a recovering batcher needs (the JAX test's records)."""
    import tempfile
    d = tempfile.mkdtemp()
    j = RequestJournal(d)
    j.append_submit(0, [1, 2, 3, 9], 6, seed=4, stop_token=7,
                    priority=2, key="a", emitted=1)
    j.append_submit(1, [5, 6], 4, seed=1, emitted=1)
    j.append_emit(0, [8, 2], 3)
    j.append_park(1, [5, 6, 3], 2)
    j.append_submit(2, [7], 3, emitted=1)
    j.append_finish(2, "finish", tokens=[7, 1, 2, 3])
    j.close()
    live, fin, skipped = RequestJournal(d).replay()
    assert skipped == []
    assert sorted(live) == [0, 1]
    assert live[0] == {"tokens": [1, 2, 3, 9, 8, 2], "n_new": 6,
                       "seed": 4, "stop": 7, "prio": 2, "key": "a",
                       "emitted": 3, "deadline_ms": None}
    assert live[1]["tokens"] == [5, 6, 3] and live[1]["emitted"] == 2
    assert list(fin) == [2] and fin[2]["tokens"] == [7, 1, 2, 3]


@pytest.mark.parametrize("segment_bytes", [None, 150])
def test_same_records_same_bytes(tmp_path, segment_bytes):
    """The same appends write byte-identical segments (one, or several
    rotated ones) in both packages."""
    _write(RequestJournal, tmp_path / "port", segment_bytes)
    _write(JJournal, tmp_path / "jax", segment_bytes)
    names = _segs(tmp_path / "port")
    assert names == _segs(tmp_path / "jax")
    assert (len(names) > 1) == (segment_bytes is not None)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "jax" / n).read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_replay(tmp_path, writer):
    """A journal written by either package replays in the other to the
    same state; its rotated segments and a corrupt record included."""
    cls = JJournal if writer == "jax" else RequestJournal
    _write(cls, tmp_path, segment_bytes=150)
    seg = tmp_path / _segs(tmp_path)[1]
    data = bytearray(seg.read_bytes())
    data[12] ^= 0x01                     # one record's payload rots
    seg.write_bytes(bytes(data))
    port, jax_ = RequestJournal(str(tmp_path)), JJournal(str(tmp_path))
    assert _state(port) == _state(jax_)
    (live, fin, skipped), max_rid, _, _ = _state(port)
    assert len(skipped) >= 1 and max_rid == 4
    assert skipped[0]["reason"].startswith("crc mismatch")


def test_torn_and_crc_records_skipped(tmp_path):
    """A torn tail and a CRC-corrupt record are SKIPPED with named
    evidence; the valid records around them still replay, as in JAX."""
    j = RequestJournal(str(tmp_path))
    j.append_submit(0, [1, 2], 5, emitted=1)
    j.append_submit(1, [3, 4], 5, emitted=1)
    j.append_emit(0, [9], 2)
    j.close()
    seg = os.path.join(str(tmp_path), _segs(tmp_path)[0])
    with open(seg, "rb") as f:
        lines = f.read().split(b"\n")
    bad = bytearray(lines[1])
    bad[-1] ^= 0x04                    # rid 1's submit: CRC mismatch
    lines[1] = bytes(bad)
    with open(seg, "wb") as f:
        f.write(b"\n".join(lines[:3]) + b"\n")
        f.write(b"00000000 {\"t\": \"submit\"")   # torn tail
    live, fin, skipped = RequestJournal(str(tmp_path)).replay()
    reasons = sorted(s["reason"] for s in skipped)
    assert len(skipped) == 2
    assert reasons[0].startswith("crc mismatch")
    assert reasons[1].startswith("torn tail")
    assert all(s["segment"].endswith(".wal") and s["record"] >= 0
               for s in skipped)
    assert sorted(live) == [0] and live[0]["tokens"] == [1, 2, 9]
    assert (live, fin, skipped) == JJournal(str(tmp_path)).replay()


def test_gc_never_truncates_live_segments(tmp_path):
    """Segments rotate at segment_bytes; GC removes only a head run of
    fully tombstoned segments, and maybe_gc only after a rotation."""
    j = RequestJournal(str(tmp_path), segment_bytes=200)
    for rid in range(4):               # all live: GC must be a no-op
        j.append_submit(rid, [1, 2, rid], 4, emitted=1)
    assert len(_segs(tmp_path)) > 1
    before = _segs(tmp_path)
    assert j.gc() == [] and _segs(tmp_path) == before
    for rid in range(4):
        j.append_finish(rid, "finish", tokens=[1, 2, rid, 5])
    for rid in range(4, 8):
        j.append_submit(rid, [1, 2, rid], 4, emitted=1)
        if rid < 7:                    # rid 7 stays LIVE in the tail
            j.append_finish(rid, "finish", tokens=[1, 2, rid, 5])
    pre = _segs(tmp_path)
    removed = j.maybe_gc()
    assert removed and len(_segs(tmp_path)) < len(pre)
    assert j.maybe_gc() == []          # no rotation since
    live, fin, skipped = RequestJournal(str(tmp_path)).replay()
    assert skipped == [] and sorted(live) == [7] and 7 not in fin
    assert j.depth_bytes == sum(os.path.getsize(tmp_path / n)
                                for n in _segs(tmp_path))
    j.close()


def test_fresh_segment_after_reopen(tmp_path):
    """A reopened journal never appends into its predecessor's tail."""
    j = RequestJournal(str(tmp_path))
    j.append_submit(0, [1], 2, emitted=1)
    j.close()
    j2 = RequestJournal(str(tmp_path))
    j2.append_emit(0, [3], 2)
    j2.close()
    assert _segs(tmp_path) == ["seg-000000.wal", "seg-000001.wal"]
    live, _, _ = RequestJournal(str(tmp_path)).replay()
    assert live[0]["tokens"] == [1, 3]
    with pytest.raises(ValueError, match="directory"):
        RequestJournal("")


def test_chaos_sites_count_as_in_jax(tmp_path):
    """``journal.append`` matches twice a record (the pre-write fire and
    the at-rest corrupt_file hook) and ``journal.replay`` once a segment,
    in both packages; a bitflip rule rots the record at rest and the
    replay skips it; an error rule refuses the append."""
    for name, cls, mod in (("port", RequestJournal, chaos),
                           ("jax", JJournal, jchaos)):
        d = tmp_path / name
        rule = mod.inject("journal.append", "nan", count=0)
        flip = mod.inject("journal.append", "bitflip", at=5, elem=-5)
        j = cls(str(d), segment_bytes=120)
        for rid in range(3):
            j.append_submit(rid, [rid, 1], 3, emitted=1)
        j.close()
        assert rule.seen == 6 and flip.fired == 1
        scan = mod.inject("journal.replay", "nan", count=0)
        live, _, skipped = cls(str(d)).replay()
        assert scan.seen == len(_segs(d))
        assert sorted(live) == [0, 1] and len(skipped) == 1
        mod.reset()
        mod.inject("journal.append", "error")
        with pytest.raises(mod.ChaosError):
            cls(str(d)).append_emit(0, [5], 2)
        mod.reset()
