"""The port's replica router (``mxnet_tpu_torch/models/router.py``) held
against the JAX package's ``ReplicaRouter`` on the CPU, mirroring
``tests/test_router.py`` and the rollout tests of
``tests/test_serving_durable.py`` at the JAX suites' small config (vocab
41, d_model 16, 2 heads, 1 layer, max_len 32, fp32): the same jobs (and
the same chaos spec, installed in both packages' chaos modules) give the
same streams, the same replica choices and the same ``breaker_events``
and ``rollout_events`` in both routers; sampled streams equal the port's
solo generate(); the all-dead raise, shedding and the SLO floor; router
recovery. JAX's ``test_router_env_knobs`` has no counterpart: the port
reads no environment, every knob is an argument (checked here).
Tolerance: exact."""

import numpy as np
import pytest

import jax.numpy as jnp

from mxnet_tpu.models import router as jrt
from mxnet_tpu.models import serving as jsv
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.observability import chaos as jchaos

from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import router as trt
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.observability import chaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=32)
V = CFG["vocab_size"]


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=3), tcfg,
            ttf.init_params(tcfg, seed=3, device="cpu"))


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _jobs(seed, n):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(1, V, rng.randint(3, 12))],
             int(rng.randint(4, 12))) for _ in range(n)]


def _both(models, build, spec=None):
    """Build a router per package with ``build(package, params, cfg)`` and
    install ``spec`` in both chaos modules. Returns the two routers."""
    jcfg, jp, tcfg, tp = models
    out = []
    for pkg, params, cfg, mod in (("port", tp, tcfg, chaos),
                                  ("jax", jp, jcfg, jchaos)):
        if spec:
            mod.install(spec)
        out.append(build(pkg, params, cfg))
    return out


def _build(pkg, params, cfg, **kw):
    if pkg == "port":
        return trt.ReplicaRouter.build(params, cfg, device="cpu", **kw)
    return jrt.ReplicaRouter.build(params, cfg, **kw)


def _batcher(pkg, params, cfg, **kw):
    if pkg == "port":
        return tsv.ContinuousBatcher(params, cfg, device="cpu", **kw)
    return jsv.ContinuousBatcher(params, cfg, **kw)


def _router(pkg, reps, **kw):
    return (trt if pkg == "port" else jrt).ReplicaRouter(reps, **kw)


def _solo(tp, tcfg, prompt, n, **kw):
    return ttf.generate(tp, np.asarray([prompt]), n, tcfg, device="cpu",
                        **kw)[0].tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_streams_and_placement_equal_jaxs(models, paged):
    """Eight jobs over two replicas: the port router's results, order and
    per-replica dispatch counts equal JAX's, every stream its solo
    generate()."""
    _, _, tcfg, tp = models
    jobs = _jobs(1, 8)
    kw = dict(paged=True, block_size=8) if paged else {}
    out = []
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=2, max_batch=2, **kw)):
        results, order = r.run(jobs)
        out.append(([results[k] for k in order],
                    [rep.dispatch_count for rep in r.replicas]))
    got, want = out
    assert [list(map(int, s)) for s in got[0]] == \
        [list(map(int, s)) for s in want[0]]
    assert got[1] == want[1] and min(got[1]) > 0
    for s, (p, n) in zip(got[0], jobs):
        assert s == _solo(tp, tcfg, p, n)


def test_sampled_streams_equal_solo(models):
    _, _, tcfg, tp = models
    jobs = [(p, n, 100 + i) for i, (p, n) in enumerate(_jobs(6, 6))]
    r = _build("port", tp, tcfg, n_replicas=2, max_batch=2, paged=True,
               block_size=8, temperature=0.8, top_k=20)
    results, order = r.run(jobs)
    for rid, (p, n, seed) in zip(order, jobs):
        assert results[rid] == _solo(tp, tcfg, p, n, temperature=0.8,
                                     top_k=20, seed=seed)


def test_routes_to_most_headroom(models):
    """Admission lands on the replica with the most free blocks, as in
    JAX."""
    jcfg, jp, tcfg, tp = models
    placed = []
    for pkg, p, c in (("port", tp, tcfg), ("jax", jp, jcfg)):
        r0 = _batcher(pkg, p, c, max_batch=4, paged=True, block_size=8,
                      num_blocks=5)
        r1 = _batcher(pkg, p, c, max_batch=4, paged=True, block_size=8,
                      num_blocks=17)
        router = _router(pkg, [r0, r1])
        router.submit([1, 2, 3], 4)
        router.step()
        placed.append((r0.active_count, r1.active_count,
                       [r.name for r in router.replicas]))
    assert placed[0] == placed[1] == (0, 1, ["r0", "r1"])


def test_chaos_kills_one_replica_drains_and_reroutes(models):
    """r1's dispatches fail from its 3rd on: its requeue cap re-raises,
    the router drains it, the survivor serves everything, streams equal
    JAX's and the solo runs."""
    _, _, tcfg, tp = models
    jobs = _jobs(2, 8)
    spec = ("serving.dispatch.r1:error:every=1:at=2;"
            "serving.dispatch.r1:error:every=1:count=0")
    out = []
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=2, max_batch=2, paged=True,
            block_size=8), spec):
        results, order = r.run(jobs)
        out.append(([list(map(int, results[k])) for k in order],
                    list(r._alive), r.breaker_events))
    assert out[0] == out[1]
    assert out[0][1] == [True, False]
    for s, (p, n) in zip(out[0][0], jobs):
        assert s == _solo(tp, tcfg, p, n)


def test_breaker_reopens_and_closes_as_jax(models):
    """With the breaker on, a replica failing at occurrences 1-4 trips,
    backs off, comes back HALF_OPEN, serves its canary and closes: the
    same ``breaker_events`` and streams as JAX's, both replicas alive."""
    _, _, tcfg, tp = models
    jobs = _jobs(4, 10)
    spec = ";".join("serving.dispatch.r1:error:at=%d" % k
                    for k in range(1, 5))
    out = []
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=2, max_batch=2, paged=True, block_size=8,
            breaker=True), spec):
        results, order = r.run(jobs)
        out.append(([list(map(int, results[k])) for k in order],
                    r.breaker_events, list(r._alive)))
    assert out[0] == out[1]
    assert out[0][1] == [("r1", "closed", "open"),
                         ("r1", "open", "half_open"),
                         ("r1", "half_open", "closed")]
    assert out[0][2] == [True, True]
    for s, (p, n) in zip(out[0][0], jobs):
        assert s == _solo(tp, tcfg, p, n)


def test_all_replicas_dead_raises(models):
    spec = ("serving.dispatch.r0:error:every=1:count=0;"
            "serving.dispatch.r1:error:every=1:count=0")
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=2, max_batch=2), spec):
        with pytest.raises(OSError):
            r.run([([1, 2, 3], 8)])


def test_shedding_over_the_queue_bound(models):
    _, _, tcfg, tp = models
    jobs = _jobs(4, 8)
    out = []
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=2, max_batch=1, paged=True, block_size=8,
            shed_queue=1)):
        results, order = r.run(jobs)
        out.append(([results[k] and list(map(int, results[k]))
                     for k in order], r.shed_rids,
                    r.health_snapshot()["serving.slo_violation.shed"]))
    assert out[0] == out[1]
    assert out[0][1] and out[0][2] == len(out[0][1])
    for s, (p, n) in zip(out[0][0], jobs):
        assert s is None or s == _solo(tp, tcfg, p, n)


def test_deadlines_expire_and_priorities_order(models):
    out = []
    for r in _both(models, lambda pkg, p, c: _build(
            pkg, p, c, n_replicas=1, max_batch=1)):
        a = r.submit([1, 2, 3], 4, priority=0)
        b = r.submit([4, 5, 6], 4, priority=2)
        c = r.submit([7, 8], 4, deadline_ms=0)
        first = r.step()
        done = dict(first)
        while r._queue or r._live:
            done.update(r.step())
        out.append((first.get(c, "x"), r.expired_rids,
                    sorted(done), [k for k in done if done[k]][:1]))
        assert done[b] is not None and done[a] is not None
    assert out[0] == out[1] and out[0][0] is None


def test_slo_floor_gates_admission(models, monkeypatch):
    """A replica reporting attainment below the floor takes no new
    admissions; with every replica below it the request sheds."""
    _, _, tcfg, tp = models
    r0 = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    r1 = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    router = trt.ReplicaRouter([r0, r1], slo_floor=0.9, shed_queue=0)
    snaps = {id(r0): 0.5, id(r1): 1.0}
    orig = tsv.ContinuousBatcher.health_snapshot

    def patched(self):
        snap = orig(self)
        snap["serving.slo_attainment"] = snaps[id(self)]
        return snap

    monkeypatch.setattr(tsv.ContinuousBatcher, "health_snapshot", patched)
    rid = router.submit([1, 2, 3], 4)
    done = {}
    while not done:
        done.update(router.step())
    assert r1._next_rid == 1 and r0._next_rid == 0 and done[rid]
    snaps[id(r1)] = 0.5
    rid2 = router.submit([1, 2, 3], 4)
    assert router.step().get(rid2, "missing") is None
    assert rid2 in router.shed_rids


def test_knobs_are_arguments_with_jaxs_defaults(models, monkeypatch):
    """The port reads no environment (JAX's test_router_env_knobs sets
    MXNET_ROUTER_*; here the variables are ignored) and the arguments
    default to JAX's values with the variables unset."""
    _, _, tcfg, tp = models
    monkeypatch.setenv("MXNET_ROUTER_SHED_QUEUE", "3")
    monkeypatch.setenv("MXNET_ROUTER_BREAKER", "1")
    r = trt.ReplicaRouter.build(tp, tcfg, n_replicas=2, max_batch=1,
                                device="cpu")
    assert r.shed_queue is None and r.slo_floor is None and not r.breaker
    assert (r._breaker_backoff, r._breaker_backoff_max,
            r._breaker_retries, r.rollout_window, r.rollout_attain) \
        == (2, 32, 5, 8, None)
    r = trt.ReplicaRouter.build(tp, tcfg, n_replicas=2, max_batch=1,
                                shed_queue=3, slo_floor=0.75, device="cpu")
    assert r.shed_queue == 3 and r.slo_floor == 0.75
    assert r.fleet_history() == {} and r.fleet_history("r0") == []
    with pytest.raises(ValueError):
        trt.ReplicaRouter([])
    with pytest.raises(NotImplementedError, match="A10"):
        trt.ReplicaRouter.build(tp, tcfg, brownout=True, device="cpu")


def _fleet(pkg, params, cfg):
    reps = [_batcher(pkg, params, cfg, max_batch=4, journal=False)
            for _ in range(2)]
    return _router(pkg, reps, journal=False)


def _drive(router, results, cap=500):
    for _ in range(cap):
        if not (router._queue or router._live or
                router.rollout_phase in ("draining", "canary")):
            return
        results.update(router.step())
    raise AssertionError("router stalled")


def _rollout(models, new_seed, spec=None, manifest=None):
    """Five jobs, one step, then a rollout to seed ``new_seed``'s weights
    in both packages. Returns [(events, results, fingerprints)]."""
    jcfg, _, tcfg, _ = models
    news = {"port": ttf.init_params(tcfg, seed=new_seed, device="cpu"),
            "jax": jtf.init_params(jcfg, seed=new_seed)}
    out = []
    for pkg, params, cfg, mod in (("port", models[3], tcfg, chaos),
                                  ("jax", models[1], jcfg, jchaos)):
        router = _fleet(pkg, params, cfg)
        order = [router.submit([1, 2, 3], 6, seed=s) for s in range(5)]
        router.step()
        if spec:
            mod.install(spec)
        router.start_rollout(news[pkg], manifest=manifest)
        results = {}
        if spec:
            with pytest.warns(RuntimeWarning, match="rolled back"):
                _drive(router, results)
        else:
            _drive(router, results)
        mod.reset()
        out.append((router.rollout_events,
                    [list(map(int, results[r])) for r in order],
                    [r.weight_fingerprint for r in router.replicas],
                    router.rollout_phase))
    return out


def test_rollout_happy_path(models, tmp_path):
    """A manifest-verified rolling upgrade mid-traffic: every replica
    drains, swaps and passes its canary; no request is dropped; the
    events, streams and fingerprints are JAX's."""
    _, _, tcfg, _ = models
    d = str(tmp_path)
    ck.save_checkpoint(d, tcfg, ttf.init_params(tcfg, seed=1, device="cpu"),
                       step=1)
    got, want = _rollout(models, 1, manifest=d)
    assert got == want
    events, results, fps, phase = got
    assert phase == "done" and len(set(fps)) == 1
    assert [e[0] for e in events] == ["start", "canary", "upgraded",
                                      "canary", "upgraded", "done"]
    assert all(len(r) == 9 for r in results)


def test_rollout_chaos_canary_rolls_back(models):
    """An injected canary fault rolls every replica back to the prior
    fingerprint; every in-flight request still delivers; JAX's events."""
    got, want = _rollout(models, 1, spec="router.rollout:error:at=1")
    assert got == want
    events, results, fps, phase = got
    assert phase == "rolled_back" and events[-1][0] == "rolled_back"
    assert fps == [tsv.params_fingerprint(models[3])] * 2
    assert all(len(r) == 9 for r in results)


def test_rollout_refuses_bad_lineage(models, tmp_path):
    _, _, tcfg, tp = models
    router = _fleet("port", tp, tcfg)
    fp0 = router.replicas[0].weight_fingerprint
    p1 = ttf.init_params(tcfg, seed=1, device="cpu")
    with pytest.raises(ck.CheckpointCorrupt):
        router.start_rollout(p1, manifest={"param_fingerprint": "0" * 8})
    d = str(tmp_path)
    ck.save_checkpoint(d, tcfg, tp, step=1)      # other weights' lineage
    with pytest.raises(ck.CheckpointCorrupt, match="refusing"):
        router.start_rollout(p1, manifest=d)
    assert router._rollout is None and router.rollout_events == []
    assert all(r.weight_fingerprint == fp0 for r in router.replicas)
    snap = router.health_snapshot()
    assert snap["router.rollout_phase"] == 0
    router.start_rollout(p1)
    snap = router.health_snapshot()
    assert snap["router.rollout_phase"] == 1
    assert snap["router.rollout_target_fp"] == int(
        tsv.params_fingerprint(p1), 16)


def test_router_recover(models, tmp_path):
    """A fleet with journals crashes mid-flight: a fresh fleet's
    recover() re-enters the queued and the admitted streams, and every
    original stream completes as the uninterrupted run's (matched by
    prompt, since recovered streams take fresh rids)."""
    _, _, tcfg, tp = models
    jobs = _jobs(7, 6)
    d = str(tmp_path)
    ref, rorder = trt.ReplicaRouter.build(
        tp, tcfg, n_replicas=2, max_batch=2, device="cpu").run(jobs)
    r = trt.ReplicaRouter.build(tp, tcfg, n_replicas=2, max_batch=2,
                                journal=d, device="cpu")
    for j in jobs:
        r.submit(*j)
    done = {}
    for _ in range(3):
        done.update(r.step())
    del r
    r2 = trt.ReplicaRouter.build(tp, tcfg, n_replicas=2, max_batch=2,
                                 journal=d, device="cpu")
    requeued, fin, skipped = r2.recover()
    assert skipped == [] and requeued
    assert r2.health_snapshot()["router.journal_lag_records"] > 0
    out = dict(fin)
    while r2._queue or r2._live or r2._redeliver:
        out.update(r2.step())
    streams = sorted(list(done.values()) + list(out.values()))
    assert streams == sorted(ref[k] for k in rorder)
