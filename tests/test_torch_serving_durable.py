"""The port batcher's durability held against the JAX package's on the CPU,
at the JAX suites' small config (vocab 41, d_model 16, 2 heads, 1 layer,
max_len 32, fp32): the request journal is off-path (streams and
``dispatch_count`` the same with it on and off, dense and paged, depth
1 and 2, spec_k on) and writes the JAX batcher's records byte for byte;
``recover()`` after a simulated crash gives JAX's recovered streams
(greedy) and the uninterrupted run's (sampled: the port resumes the
noise counter); the rid counter moves past the journal; a real kill -9
at a journal commit point (a subprocess importing torch and the port
only) under paged x spec x pipeline recovers exactly; the idempotency
window survives recovery; ``swap_weights`` verifies, refuses and rolls
back; the OOM shrink parks the same blocks and preempts the same lanes
as JAX's, with no lane rebuild; the health snapshot carries the
journal's keys. Tolerance: exact (token streams, bytes, counts)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import serving as jsv
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.models.journal import RequestJournal as JJournal
from mxnet_tpu.observability import chaos as jchaos

from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.models.journal import RequestJournal
from mxnet_tpu_torch.observability import chaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=32)
JOBS = [([1, 2, 3], 6, 0), ([4, 5], 6, 1), ([7, 8, 9], 6, 2)]
PAGED = dict(paged=True, block_size=4, num_blocks=24)
SAMPLE = dict(temperature=0.8, top_k=20)


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=0), tcfg,
            ttf.init_params(tcfg, seed=0, device="cpu"))


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _port(tp, tcfg, **kw):
    return tsv.ContinuousBatcher(tp, tcfg, device="cpu", **kw)


def _segs(d):
    return sorted(n for n in os.listdir(str(d)) if n.endswith(".wal"))


@pytest.mark.parametrize("kw", [
    dict(max_batch=2), dict(max_batch=2, pipeline_depth=2),
    dict(max_batch=2, **PAGED), dict(max_batch=2, pipeline_depth=2, **PAGED),
    dict(max_batch=2, spec_k=2, pipeline_depth=2, **PAGED),
    dict(max_batch=2, spec_k=2)],
    ids=["dense", "dense-d2", "paged", "paged-d2", "paged-spec-d2",
         "dense-spec"])
def test_journal_is_off_path_and_writes_jaxs_records(models, tmp_path, kw):
    """With the journal attached the streams and the dispatch count equal
    a journal-less run's; the replay holds every request finished; and
    the segments are the JAX batcher's, byte for byte."""
    jcfg, jp, tcfg, tp = models

    def run(srv):
        res, order = srv.run(list(JOBS))
        return [res[r] for r in order], srv.dispatch_count

    off = run(_port(tp, tcfg, **kw))
    on = run(_port(tp, tcfg, journal=str(tmp_path / "port"), **kw))
    assert on == off
    live, fin, skipped = RequestJournal(str(tmp_path / "port")).replay()
    assert not live and not skipped and len(fin) == len(JOBS)
    want = run(jsv.ContinuousBatcher(jp, jcfg, journal=str(tmp_path / "jax"),
                                     **kw))
    assert on == want
    assert _segs(tmp_path / "port") == _segs(tmp_path / "jax")
    for n in _segs(tmp_path / "port"):
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "jax" / n).read_bytes()


def _crash_and_recover(make, jdir, steps=2):
    """Admit JOBS, step ``steps`` times, drop the batcher (the journal is
    all that survives), recover into a fresh one and step to the end.
    Returns ({old rid: stream}, resumed, skipped, the fresh batcher)."""
    srv = make(jdir)
    for p, n, s in JOBS:
        srv.admit(p, n, seed=s)
    for _ in range(steps):
        srv.step()
    del srv
    srv2 = make(jdir)
    resumed, done, skipped = srv2.recover()
    got = dict(done)
    new2old = {v: k for k, v in resumed.items() if v is not None}
    for _ in range(200):
        if all(n in got or o in got for n, o in new2old.items()):
            break
        for rid, toks in srv2.step().items():
            got[new2old.get(rid, rid)] = toks
    return got, resumed, skipped, srv2


@pytest.mark.parametrize("kw", [dict(), dict(pipeline_depth=2, **PAGED)],
                         ids=["dense", "paged-d2"])
def test_recover_greedy_matches_jaxs_recovery(models, tmp_path, kw):
    jcfg, jp, tcfg, tp = models
    got, resumed, skipped, srv = _crash_and_recover(
        lambda d: _port(tp, tcfg, max_batch=4, journal=d, **kw),
        str(tmp_path / "port"))
    want, jres, jskip, _ = _crash_and_recover(
        lambda d: jsv.ContinuousBatcher(jp, jcfg, max_batch=4, journal=d,
                                        **kw), str(tmp_path / "jax"))
    assert skipped == jskip == [] and resumed == jres and resumed
    assert got == want
    srv.check_invariants(quiesce=True)
    ref, order = _port(tp, tcfg, max_batch=4, **kw).run(list(JOBS))
    assert [got[r] for r in order] == [ref[r] for r in order]


def test_recover_sampled_equals_the_uninterrupted_run(models, tmp_path):
    """Sampled streams resume at their noise counter: the recovered run
    equals the uninterrupted one and each solo generate(seed) (the JAX
    batcher's recovery replays its own key chain instead)."""
    _, _, tcfg, tp = models
    for kw in (dict(), dict(pipeline_depth=2, **PAGED)):
        d = str(tmp_path / str(len(kw)))
        got, resumed, skipped, srv = _crash_and_recover(
            lambda j: _port(tp, tcfg, max_batch=4, journal=j, **SAMPLE,
                            **kw), d)
        assert skipped == [] and resumed
        ref, order = _port(tp, tcfg, max_batch=4, **SAMPLE, **kw).run(
            list(JOBS))
        assert [got[r] for r in order] == [ref[r] for r in order]
        for (p, n, s), rid in zip(JOBS, order):
            assert got[rid] == ttf.generate(
                tp, np.asarray([p]), n, tcfg, seed=s, device="cpu",
                **SAMPLE)[0].tolist()
        srv.check_invariants(quiesce=True)


def test_recover_of_a_jax_written_journal(models, tmp_path):
    """A crash journal written by the JAX batcher recovers in the port to
    JAX's own recovered streams."""
    jcfg, jp, tcfg, tp = models
    d = str(tmp_path / "j")
    srv = jsv.ContinuousBatcher(jp, jcfg, max_batch=4, journal=d)
    for p, n, s in JOBS:
        srv.admit(p, n, seed=s)
    srv.step()
    srv.step()
    del srv
    import shutil
    shutil.copytree(d, str(tmp_path / "copy"))
    outs = []
    for srv in (_port(tp, tcfg, max_batch=4, journal=d),
                jsv.ContinuousBatcher(jp, jcfg, max_batch=4,
                                      journal=str(tmp_path / "copy"))):
        resumed, got, skipped = srv.recover()
        new2old = {v: k for k, v in resumed.items()}
        while srv.active_count:
            for rid, toks in srv.step().items():
                got[new2old.get(rid, rid)] = toks
        outs.append((resumed, got, skipped))
    assert outs[0] == outs[1] and len(outs[0][1]) == len(JOBS)


def test_recover_bumps_the_rid_counter(models, tmp_path):
    _, _, tcfg, tp = models
    srv = _port(tp, tcfg, max_batch=2, journal=str(tmp_path))
    srv.admit([1, 2, 3], 4)
    del srv
    srv2 = _port(tp, tcfg, max_batch=2, journal=str(tmp_path))
    resumed, _, _ = srv2.recover()
    assert resumed == {0: 1}
    assert srv2.admit([4, 5], 4) == 2
    with pytest.raises(RuntimeError, match="journal"):
        _port(tp, tcfg).recover()


def test_recover_parks_what_the_pool_cannot_hold(models, tmp_path):
    """A live record that finds no lane is parked on ``preempted`` (its
    record stays live) and run() resumes it."""
    _, _, tcfg, tp = models
    d = str(tmp_path)
    srv = _port(tp, tcfg, max_batch=3, journal=d)
    for p, n, s in JOBS:
        srv.admit(p, n, seed=s)
    srv.step()
    del srv
    srv2 = _port(tp, tcfg, max_batch=2, journal=d)
    resumed, _, _ = srv2.recover()
    assert sorted(resumed) == [0, 1, 2] and resumed[2] is None
    assert [r.rid for r, _ in srv2.preempted] == [2]
    out, _ = srv2.run([])
    ref, order = _port(tp, tcfg, max_batch=3).run(list(JOBS))
    assert out[resumed[0]] == ref[order[0]]
    assert ref[order[2]] in out.values()


_KILL9 = r"""
import sys
from mxnet_tpu_torch.models import transformer as T, serving as S
from mxnet_tpu_torch.observability import chaos
cfg = T.TransformerConfig(vocab_size=41, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, max_len=32)
params = T.init_params(cfg, seed=0, device="cpu")
srv = S.ContinuousBatcher(params, cfg, max_batch=4, paged=True,
                          block_size=4, num_blocks=24, pipeline_depth=2,
                          spec_k=2, spec_ngram=2, greedy=True,
                          journal=sys.argv[1], device="cpu")
# every record is two matches (the pre-write fire and the at-rest
# corrupt_file hook): at=8 kills at the 5th record's pre-write
chaos.install("journal.append:crash:at=8:code=9")
for p, n, s in [([1, 2, 3], 6, 0), ([4, 5], 6, 1), ([7, 8, 9], 6, 2)]:
    srv.admit(p, n, seed=s)
done = {}
for _ in range(300):
    done.update(srv.step())
    if len(done) == 3:
        break
print("UNREACHABLE", flush=True)
"""


def test_recover_after_kill9_subprocess(models, tmp_path):
    """A real hard kill at a journal commit point under paged x spec x
    pipeline; the parent recovers the journal exactly (JAX's
    ``test_recover_after_kill9_subprocess``, on the port)."""
    _, _, tcfg, tp = models
    kw = dict(max_batch=4, pipeline_depth=2, spec_k=2, spec_ngram=2,
              greedy=True, **PAGED)
    ref, order = _port(tp, tcfg, **kw).run(list(JOBS))
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _KILL9, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 9, proc.stderr[-2000:]
    assert "UNREACHABLE" not in proc.stdout
    srv = _port(tp, tcfg, journal=str(tmp_path), **kw)
    resumed, done, skipped = srv.recover()
    assert skipped == [] and resumed
    got = dict(done)
    new2old = {v: k for k, v in resumed.items() if v is not None}
    for _ in range(300):
        if all(n in got or o in got for n, o in new2old.items()):
            break
        for rid, toks in srv.step().items():
            got[new2old.get(rid, rid)] = toks
    for rid in order:
        assert got.get(rid) == ref[rid], rid
    srv.check_invariants(quiesce=True)


def test_idempotency_window_survives_recovery(models, tmp_path):
    """After a crash a re-submit of a FINISHED key re-delivers through the
    next step() instead of recomputing, as in JAX."""
    jcfg, jp, tcfg, tp = models
    outs = []
    for name, make in (
            ("port", lambda d: _port(tp, tcfg, max_batch=2, journal=d)),
            ("jax", lambda d: jsv.ContinuousBatcher(jp, jcfg, max_batch=2,
                                                    journal=d))):
        d = str(tmp_path / name)
        srv = make(d)
        rid = srv.admit([1, 2, 3], 5, key="k")
        done = {}
        while rid not in done:
            done.update(srv.step())
        del srv
        srv2 = make(d)
        srv2.recover()
        disp0 = srv2.dispatch_count
        assert srv2.admit([1, 2, 3], 5, key="k") == rid
        out = srv2.step()
        assert out.get(rid) == done[rid] and srv2.dispatch_count == disp0
        outs.append(out)
    assert outs[0] == outs[1]


def test_swap_weights_verified_refused_and_rolled_back(models, tmp_path):
    """A manifest-verified swap lands mid-stream without dropping the
    request, and the stream is JAX's under the same swap; a fingerprint
    mismatch refuses before the weights change; swapping back restores
    the prior fingerprint."""
    jcfg, jp, tcfg, tp = models
    p1 = ttf.init_params(tcfg, seed=1, device="cpu")
    ckdir = str(tmp_path / "ck")
    ck.save_checkpoint(ckdir, tcfg, p1, step=1)
    streams = []
    for srv, new in ((_port(tp, tcfg, max_batch=2), p1),
                     (jsv.ContinuousBatcher(jp, jcfg, max_batch=2),
                      jtf.init_params(jcfg, seed=1))):
        rid = srv.admit([1, 2, 3], 8)
        srv.step()
        info = srv.swap_weights(new, manifest=ckdir)
        assert info["fingerprint"] == srv.weight_fingerprint
        assert info["mode"] == "resident"
        done = {}
        while rid not in done:
            done.update(srv.step())
        assert len(done[rid]) == 3 + 8
        srv.check_invariants(quiesce=True)
        streams.append((info, done[rid]))
    assert streams[0] == streams[1]
    srv = _port(tp, tcfg, max_batch=2, **PAGED, pipeline_depth=2)
    fp0 = srv.weight_fingerprint
    with pytest.raises(ck.CheckpointCorrupt, match="refusing"):
        srv.swap_weights(p1, manifest={"param_fingerprint": "0" * 8})
    assert srv.weight_fingerprint == fp0 and srv.params is tp
    rid = srv.admit([1, 2, 3], 8)
    srv.step()
    assert srv.swap_weights(p1)["previous"] == fp0
    assert srv.swap_weights(tp)["fingerprint"] == fp0
    out = {}
    while srv.active_count:
        out.update(srv.step())
    assert out[rid] == ttf.generate(tp, np.asarray([[1, 2, 3]]), 8, tcfg,
                                    device="cpu")[0].tolist()
    srv.check_invariants(quiesce=True)


def _oom_drive(srv, mod):
    """Four requests whose lifetimes promise the whole pool (2 + 2 + 2 + 3
    of its 9 usable blocks), so the shrink must preempt to park its 2
    blocks; an injected oom at the 3rd dispatch."""
    mod.install("serving.dispatch:oom:at=2")
    for p, n, s in JOBS + [([2, 9, 4, 7], 8, 3)]:
        assert srv.admit(p, n, seed=s) is not None
    out = {}
    out.update(srv.step())
    out.update(srv.step())
    out.update(srv.step())                 # the oom: the pool shrinks
    parked = srv._alloc.parked_blocks
    victims = [r.rid for r, _ in srv.preempted]
    res, _ = srv.run([])
    out.update(res)
    mod.reset()
    return out, parked, victims


@pytest.mark.parametrize("kw", [dict(), dict(pipeline_depth=2),
                                dict(pipeline_depth=2, spec_k=2)],
                         ids=["sync", "pipelined", "spec"])
def test_oom_shrink_matches_jax(models, kw):
    """The OOM shrink parks the same blocks and preempts the same lanes as
    JAX's batcher, counts one failure and rebuilds nothing: the pool and
    cache tensors survive, and the streams are JAX's."""
    jcfg, jp, tcfg, tp = models
    pool = dict(paged=True, block_size=4, num_blocks=10)
    srv = _port(tp, tcfg, max_batch=4, **pool, **kw)
    pool_id = id(srv._pool[0]["k"])
    rebuilds = []
    srv._init_lanes = lambda: rebuilds.append(1)
    got = _oom_drive(srv, chaos)
    want = _oom_drive(jsv.ContinuousBatcher(jp, jcfg, max_batch=4, **pool,
                                            **kw), jchaos)
    assert got == want
    assert got[1] > 0 and got[2]
    assert srv.dispatch_failures == 1 and not rebuilds
    assert id(srv._pool[0]["k"]) == pool_id
    srv.check_invariants()


def test_oom_on_dense_lanes_requeues(models):
    """Dense lanes have no pool to shrink: an oom requeues as any failed
    dispatch does, and the streams stay exact."""
    _, _, tcfg, tp = models
    chaos.install("serving.dispatch:oom:at=1")
    srv = _port(tp, tcfg, max_batch=2)
    res, order = srv.run(list(JOBS))
    chaos.reset()
    ref, _ = _port(tp, tcfg, max_batch=2).run(list(JOBS))
    assert srv.dispatch_failures == 1
    assert [res[r] for r in order] == [ref[r] for r in order]


def test_grow_pool_chaos_site(models):
    _, _, tcfg, tp = models
    srv = _port(tp, tcfg, max_batch=2, **PAGED)
    chaos.inject("kv.pool.grow", "oom")
    with pytest.raises(chaos.ChaosResourceExhausted):
        srv.grow_pool(4)
    assert srv.num_blocks == PAGED["num_blocks"]


def test_health_snapshot_durability_keys(models, tmp_path):
    jcfg, jp, tcfg, tp = models
    snaps = []
    for name, srv in (
            ("port", _port(tp, tcfg, max_batch=2,
                           journal=str(tmp_path / "port"))),
            ("jax", jsv.ContinuousBatcher(jp, jcfg, max_batch=2,
                                          journal=str(tmp_path / "jax")))):
        srv.admit([1, 2, 3], 4)
        snaps.append({k: v for k, v in srv.health_snapshot().items()
                      if k.startswith("serving.journal")
                      or k.startswith("serving.weight")})
    assert snaps[0] == snaps[1]
    assert snaps[0]["serving.journal_depth_bytes"] > 0
    assert snaps[0]["serving.journal_lag_records"] == 1
    assert "serving.journal_depth_bytes" not in \
        _port(tp, tcfg).health_snapshot()


def test_swap_empties_the_dense_prefix_cache(models):
    """A swap empties the prefix cache, whose K/V came from the old
    weights: a later admission through a prefix cached before the swap
    gives the new weights' stream. (The JAX batcher keeps a dense prefix
    cache across a swap with live requests and serves the old K/V;
    ROADMAP section C.)"""
    _, _, tcfg, tp = models
    p1 = ttf.init_params(tcfg, seed=1, device="cpu")
    for kw in (dict(), dict(pipeline_depth=2, **PAGED)):
        srv = _port(tp, tcfg, max_batch=2, **kw)
        srv.cache_prefix([5, 6, 7, 8])
        srv.admit([1, 2, 3], 6)
        srv.step()
        srv.swap_weights(p1)
        rid = srv.admit([5, 6, 7, 8, 9], 6)
        out = {}
        while srv.active_count:
            out.update(srv.step())
        assert out[rid] == ttf.generate(p1, np.asarray([[5, 6, 7, 8, 9]]), 6,
                                        tcfg, device="cpu")[0].tolist()
