"""The kvstore stack in a real 4-rank world: the dist store's push, pull
and fused pushpull, ``fusion.ShardSlot`` (sgd, nag, adam, and bf16 with
an fp32 master) and its state round trip, the Gluon ``Trainer`` over
``dist_sync`` with the sharded update and with 2-bit compression,
``_contrib_SyncBatchNorm``'s forward and gradients, and a ``Module.fit``
step on an MLP through ``dist_sync``. Each rank is a process on the
CPU, joined over gloo.

A module fixture writes the inputs as .npy files and starts the world
once: this file run as a script, once per rank, joined through a
FileStore under the fixture's directory (as tests/test_torch_mesh_world.py
does). While the ranks run, the parent computes the references with the
JAX package: its ``KVStoreTPUSync`` and ``ShardSlot`` on 4 of the
virtual CPU devices (one worker a device, as the port has one a rank);
for the Trainer, a JAX store fed each rank's gradients (from JAX's own
Gluon net on that rank's rows) and holding the optimizer; JAX's
BatchNorm over the concatenated global batch; and JAX's Module step on
the whole batch. A rank imports torch and the port only, and asserts
that JAX is not loaded. A rank that fails fails the fixture; a world
that has not finished within WORLD_TIMEOUT seconds is killed and fails
it too. A host whose loopback interface gloo does not pick may need
GLOO_SOCKET_IFNAME=lo.

Tolerances (fp32): sums over ranks within rtol 1e-6 (gloo and XLA add
four values in their own orders); the sharded updates, the Trainer's
and the Module's parameters within rtol = atol = 1e-5 (a bf16 lane's
weights within one bf16 ulp, 2^-7 relative); SyncBatchNorm's output and
gradients within rtol = atol = 1e-5. State round trips and the
per-replica bytes are exact.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
WORLD_TIMEOUT = 150
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
SHAPES = [(5, 3), (7,), (2, 2, 3)]       # the store's keys 0, 1, 2
SHARD_STEPS = 3
SHARD_RULES = {"sgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
               "sgd_plain": dict(learning_rate=0.1, wd=1e-3),
               "nag": dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
               "adam": dict(learning_rate=0.01, wd=1e-3),
               "sgd_bf16": dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                                multi_precision=True)}
TRAIN_STEPS = 2
TRAIN_OPT = dict(learning_rate=0.5, momentum=0.9, wd=1e-3)
COMPRESSION = {"type": "2bit", "threshold": 0.05}
BN = dict(eps=1e-3, momentum=0.9)


def _inputs():
    rng = np.random.RandomState(21)
    x = {"w0": rng.randn(sum(int(np.prod(s)) for s in SHAPES))
         .astype(np.float32),
         "push": rng.randn(WORLD, 2, sum(int(np.prod(s)) for s in SHAPES))
         .astype(np.float32),
         "shard_w": rng.randn(37).astype(np.float32),
         "shard_g": rng.randn(SHARD_STEPS, WORLD, 37).astype(np.float32),
         "net_x": rng.randn(4 * WORLD, 5).astype(np.float32),
         "net_y": rng.randint(0, 3, 4 * WORLD).astype(np.float32),
         "net_w1": (rng.randn(6, 5) * 0.5).astype(np.float32),
         "net_b1": (rng.randn(6) * 0.1).astype(np.float32),
         "net_w2": (rng.randn(3, 6) * 0.5).astype(np.float32),
         "net_b2": (rng.randn(3) * 0.1).astype(np.float32),
         "bn_x": (rng.randn(2 * WORLD, 3, 4, 4) * 2 + 1).astype(np.float32),
         "bn_gamma": rng.uniform(0.5, 1.5, 3).astype(np.float32),
         "bn_beta": rng.randn(3).astype(np.float32),
         "bn_mm": (rng.randn(3) * 0.1).astype(np.float32),
         "bn_mv": rng.uniform(0.5, 1.5, 3).astype(np.float32),
         "bn_dy": rng.randn(2 * WORLD, 3, 4, 4).astype(np.float32)}
    return x


def _split(flat):
    out, o = [], 0
    for s in SHAPES:
        n = int(np.prod(s))
        out.append(flat[o:o + n].reshape(s))
        o += n
    return out


# ------------------------------------------------------------- parent ---

def _jax_store(x):
    """The dist store over 4 devices: push of each rank's two workers
    (JAX: eight workers, one per pushed value, summed), and the fused
    pushpull with an SGD optimizer on the store."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.kvstore import KVStoreTPUSync
    from mxnet_tpu.parallel import make_mesh
    mesh = make_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])
    keys = list(range(len(SHAPES)))
    workers = [[_split(x["push"][r, w])[k] for r in range(WORLD)
                for w in range(2)] for k in keys]
    out = {}
    kv = KVStoreTPUSync(mesh)
    kv.init(keys, [jmx.nd.array(a) for a in _split(x["w0"])])
    kv.push(keys, [[jmx.nd.array(a) for a in ws] for ws in workers])
    outs = [jmx.nd.zeros(s) for s in SHAPES]
    kv.pull(keys, outs)
    out["pushed"] = [o.asnumpy() for o in outs]
    kv = KVStoreTPUSync(mesh)
    kv.init(keys, [jmx.nd.array(a) for a in _split(x["w0"])])
    kv.set_optimizer(jmx.optimizer.create("sgd", **TRAIN_OPT))
    for _ in range(2):
        kv.pushpull_fused(keys, [[jmx.nd.array(a) for a in ws]
                                 for ws in workers], out=outs)
    out["fused"] = [o.asnumpy() for o in outs]
    return out


def _jax_shard(x):
    """JAX's ShardSlot on 4 devices, fed the 4 workers' flat gradients
    (a reduce-scatter), per rule: the whole flat weight after each step,
    and the per-replica state bytes."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import fusion as jf
    out = {}
    for name, hyper in SHARD_RULES.items():
        dtype = jnp.bfloat16 if name.endswith("bf16") else jnp.float32
        lane = jf.plan_buckets([("w", (37,), dtype)])[0].lanes[0]
        rule = name.split("_")[0]
        opt = jmx.optimizer.create(rule, rescale_grad=0.25, **hyper)
        slot = jf.ShardSlot(lane, jax.devices()[:WORLD],
                            {"w": jnp.asarray(x["shard_w"], dtype)},
                            jf.FlatOptimizer.supports(opt))
        steps = []
        for s in range(SHARD_STEPS):
            flats = [jf.pack_lane(lane, {"w": jnp.asarray(
                x["shard_g"][s, r], dtype)}, pad_to=slot.l_pad)
                for r in range(WORLD)]
            steps.append(np.asarray(slot.step(flats), np.float32))
        out[name] = (steps, slot.state_bytes_per_replica,
                     slot.state_bytes_total)
    return out


def _jax_net(jmx, x):
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(6, in_units=5, activation="relu"),
            jmx.gluon.nn.Dense(3, in_units=6))
    net.initialize()
    for p, key in zip(net.collect_params().values(),
                      ("net_w1", "net_b1", "net_w2", "net_b2")):
        p.set_data(jmx.nd.array(x[key]))
    return net


def _jax_trainer(x, compression):
    """A JAX store holding the optimizer, fed each rank's gradients of
    the summed loss on its rows (JAX's own Gluon net), with each rank as
    one worker: the Trainer's math over the world."""
    import mxnet_tpu as jmx
    net = _jax_net(jmx, x)
    params = list(net.collect_params().values())
    kv = jmx.kvstore.create("local")
    if compression:
        kv.set_gradient_compression(COMPRESSION)
    kv.init(list(range(4)), [p.data() for p in params])
    kv.set_optimizer(jmx.optimizer.create(
        "sgd", rescale_grad=1.0 / len(x["net_y"]), **TRAIN_OPT))
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    n = len(x["net_y"]) // WORLD
    for _ in range(TRAIN_STEPS):
        grads = [[] for _ in params]
        for r in range(WORLD):
            with jmx.autograd.record():
                loss = loss_fn(net(jmx.nd.array(x["net_x"][r * n:(r + 1) * n])),
                               jmx.nd.array(x["net_y"][r * n:(r + 1) * n]))
            loss.backward()
            for g, p in zip(grads, params):
                g.append(p.grad().copy())
        kv.push(list(range(4))[::-1], grads[::-1])
        for i, p in enumerate(params):
            out = p.data().copy()
            kv.pull(i, out)
            p.set_data(out)
    return [p.data().asnumpy() for p in params]


def _jax_bn(x):
    """JAX's BatchNorm over the concatenated global batch: the output,
    the batch statistics and the gradients of sum(out * dy)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import nn as jnn

    def f(d, g, b):
        out, mean, var = jnn.batch_norm(
            d, g, b, jnp.asarray(x["bn_mm"]), jnp.asarray(x["bn_mv"]),
            fix_gamma=False, is_train=True, **BN)
        return out, (mean, var)

    args = (jnp.asarray(x["bn_x"]), jnp.asarray(x["bn_gamma"]),
            jnp.asarray(x["bn_beta"]))
    out, (mean, var) = f(*args)
    _, pull = jax.vjp(lambda d, g, b: f(d, g, b)[0], *args)
    dx, dg, db = pull(jnp.asarray(x["bn_dy"]))
    return [np.asarray(a) for a in (out, mean, var, dx, dg, db)]


def _mlp(mx):
    d = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(d, num_hidden=6, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _module_params(x):
    return {"fc1_weight": x["net_w1"], "fc1_bias": x["net_b1"],
            "fc2_weight": x["net_w2"], "fc2_bias": x["net_b2"]}


def _jax_module(x):
    """JAX's Module on the whole batch, no store: one epoch of two
    batches of 8 rows (batch i = every rank's batch i, concatenated)."""
    import mxnet_tpu as jmx
    n = len(x["net_y"]) // WORLD
    half = n // 2
    order = np.concatenate([np.arange(r * n + b * half, r * n + (b + 1) * half)
                            for b in range(2) for r in range(WORLD)])
    it = jmx.io.NDArrayIter(x["net_x"][order], x["net_y"][order],
                            batch_size=half * WORLD,
                            label_name="softmax_label")
    mod = jmx.mod.Module(_mlp(jmx), context=jmx.cpu())
    mod.fit(it, num_epoch=1, kvstore=None, optimizer="sgd",
            optimizer_params=dict(TRAIN_OPT),
            arg_params={k: jmx.nd.array(v)
                        for k, v in _module_params(x).items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(directory, references): the world has run and written each rank's
    results there."""
    path = tmp_path_factory.mktemp("kvstore_world")
    x = _inputs()
    for name, arr in x.items():
        np.save(path / (name + ".npy"), arr)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    logs = [open(path / ("rank%d.log" % rank), "w") for rank in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(path)], env=env,
        stdout=log, stderr=subprocess.STDOUT) for rank, log in enumerate(logs)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        refs = {"store": _jax_store(x), "shard": _jax_shard(x),
                "trainer": _jax_trainer(x, False),
                "trainer_2bit": _jax_trainer(x, True),
                "bn": _jax_bn(x), "module": _jax_module(x)}
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                pytest.fail("the %d-rank world did not finish within %d s"
                            % (WORLD, WORLD_TIMEOUT))
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            log = (path / ("rank%d.log" % rank)).read_text()
            pytest.fail("rank %d exited %d:\n%s" % (rank, p.returncode,
                                                     log[-4000:]))
    return path, refs


def _rank(path, rank):
    return np.load(path / ("r%d.npz" % rank))


def _info(path, rank):
    return json.loads((path / ("info.r%d.json" % rank)).read_text())


def test_ranks_load_no_jax_and_see_the_world(world):
    path, _ = world
    for rank in range(WORLD):
        info = _info(path, rank)
        assert info["jax_loaded"] == []
        assert info["store"] == {"rank": rank, "num_workers": WORLD,
                                 "type": "dist_tpu_sync",
                                 "shard_update": True}


def test_dist_push_pull_and_fused_pushpull_match_jax(world):
    """A push sums every rank's two workers; the fused pushpull with SGD
    on the store updates every rank's weights alike."""
    path, refs = world
    for rank in range(WORLD):
        got = _rank(path, rank)
        for k, s in enumerate(SHAPES):
            np.testing.assert_allclose(got["pushed%d" % k],
                                       refs["store"]["pushed"][k],
                                       **SUM_TOL)
            np.testing.assert_allclose(got["fused%d" % k],
                                       refs["store"]["fused"][k], **TOL)
        stats = _info(path, rank)["fused_stats"]
        assert stats == {"collectives": 2, "keys": 2 * len(SHAPES),
                         "buckets": 2, "shard_updates": 0}


@pytest.mark.parametrize("rule", sorted(SHARD_RULES))
def test_shard_slot_matches_jax(world, rule):
    """Each rank updates its quarter of the flat master and state and
    all-gathers the weight: every step's whole flat weight is JAX's
    replicated update; the state bytes a replica are a quarter of the
    total."""
    path, refs = world
    steps, per_replica, total = refs["shard"][rule]
    tol = BF16_TOL if rule.endswith("bf16") else TOL
    for rank in range(WORLD):
        got = _rank(path, rank)["shard_" + rule]
        for s in range(SHARD_STEPS):
            np.testing.assert_allclose(got[s][:37], steps[s][:37],
                                       err_msg="step %d" % s, **tol)
        info = _info(path, rank)["shard"][rule]
        assert info["per_replica"] == per_replica == total // WORLD
        assert info["total"] == total
        assert info["round_trip"] is True


def test_trainer_shard_update_matches_jax(world):
    """Trainer over dist_sync(shard_update=True): update_on_kvstore comes
    on by itself, every bucket lane runs the sharded update, and the
    parameters after the steps are a JAX store's fed every rank's
    gradients. save_states/load_states round-trips the fused shard
    payload: a resumed trainer steps exactly as the one that saved."""
    path, refs = world
    for rank in range(WORLD):
        got = _rank(path, rank)
        info = _info(path, rank)["trainer"]
        assert info["update_on_kvstore"] is True
        assert info["stats"]["shard_updates"] == info["stats"]["buckets"] \
            == TRAIN_STEPS and info["stats"]["collectives"] == \
            2 * TRAIN_STEPS
        assert info["payload"] == "__fused_shard_v1__"
        assert info["resumed_equal"] is True
        for i, want in enumerate(refs["trainer"]):
            np.testing.assert_allclose(got["trainer%d" % i], want, **TOL)


def test_trainer_with_compression_matches_jax(world):
    path, refs = world
    for rank in range(WORLD):
        got = _rank(path, rank)
        assert _info(path, rank)["trainer_2bit"]["update_on_kvstore"] \
            is False
        for i, want in enumerate(refs["trainer_2bit"]):
            np.testing.assert_allclose(got["trainer_2bit%d" % i], want,
                                       **TOL)


def test_sync_batch_norm_matches_jax_over_the_global_batch(world):
    """Each rank normalises its quarter with the global batch's
    statistics: its output rows, the batch mean and variance are JAX's
    BatchNorm over the whole batch, its data gradient is JAX's rows, and
    the ranks' gamma and beta gradients sum to JAX's."""
    path, refs = world
    out, mean, var, dx, dg, db = refs["bn"]
    n = out.shape[0] // WORLD
    dgs, dbs = [], []
    for rank in range(WORLD):
        got = _rank(path, rank)
        rows = slice(rank * n, (rank + 1) * n)
        np.testing.assert_allclose(got["bn_out"], out[rows], **TOL)
        np.testing.assert_allclose(got["bn_mean"], mean, **TOL)
        np.testing.assert_allclose(got["bn_var"], var, **TOL)
        np.testing.assert_allclose(got["bn_dx"], dx[rows], **TOL)
        dgs.append(got["bn_dg"])
        dbs.append(got["bn_db"])
    np.testing.assert_allclose(np.sum(dgs, 0), dg, **TOL)
    np.testing.assert_allclose(np.sum(dbs, 0), db, **TOL)


def test_module_fit_over_dist_sync_matches_jax(world):
    """Module.fit on each rank's quarter through dist_sync (rescale
    1 / (batch x num_workers), the all-reduced gradient, the update on
    the store) gives JAX's Module step on the whole batch."""
    path, refs = world
    for rank in range(WORLD):
        got = _rank(path, rank)
        info = _info(path, rank)["module"]
        assert info["update_on_kvstore"] is True
        assert info["rescale_grad"] == 1.0 / (2 * WORLD)
        for k, want in refs["module"].items():
            np.testing.assert_allclose(got["module_" + k], want, err_msg=k,
                                       **TOL)


# --------------------------------------------------------------- rank ---

def _rank_main(rank, path):
    import pickle
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import fusion

    torch.set_num_threads(1)
    path = Path(path)
    parallel.init_distributed("file://" + str(path / "store"), WORLD, rank)
    x = {n: np.load(path / (n + ".npy")) for n in _inputs()}
    res, info = {}, {}
    ctx = mt.cpu()
    ctx.__enter__()
    nd = mt.nd
    keys = list(range(len(SHAPES)))

    # the dist store: push of two workers, pull; fused pushpull with SGD
    kv = mt.kvstore.create("dist_sync", shard_update=True)
    info["store"] = {"rank": kv.rank, "num_workers": kv.num_workers,
                     "type": kv.type,
                     "shard_update": kv.supports_shard_update()}
    kv.barrier()
    workers = [[nd.array(_split(x["push"][rank, w])[k]) for w in range(2)]
               for k in keys]
    kv.init(keys, [nd.array(a) for a in _split(x["w0"])])
    kv.push(keys, workers)
    outs = [nd.zeros(s) for s in SHAPES]
    kv.pull(keys, outs)
    for k, o in enumerate(outs):
        res["pushed%d" % k] = o.asnumpy()
    kv = mt.kvstore.create("dist_sync")
    kv.init(keys, [nd.array(a) for a in _split(x["w0"])])
    kv.set_optimizer(mt.optimizer.create("sgd", **TRAIN_OPT))
    for _ in range(2):
        kv.pushpull_fused(keys, workers, out=outs)
    for k, o in enumerate(outs):
        res["fused%d" % k] = o.asnumpy()
    info["fused_stats"] = dict(kv.dispatch_stats)

    # ShardSlot per rule, and its state round trip
    info["shard"] = {}
    for name, hyper in SHARD_RULES.items():
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        lane = fusion.plan_buckets([("w", (37,), dtype)])[0].lanes[0]
        opt = mt.optimizer.create(name.split("_")[0], rescale_grad=0.25,
                                  **hyper)
        slot = fusion.ShardSlot(
            lane, None, {"w": torch.from_numpy(x["shard_w"]).to(dtype)},
            fusion.FlatOptimizer.supports(opt))
        steps = []
        snap = None
        for s in range(SHARD_STEPS):
            if s == SHARD_STEPS - 1:
                snap = slot.get_state()
            g = torch.from_numpy(x["shard_g"][s, rank]).to(dtype)
            steps.append(slot.step([fusion.pack_lane(
                lane, {"w": g}, pad_to=slot.l_pad)]).float().numpy())
        last = steps[-1]
        slot.set_state(pickle.loads(pickle.dumps(snap)))
        again = slot.step([fusion.pack_lane(lane, {"w": torch.from_numpy(
            x["shard_g"][-1, rank]).to(dtype)}, pad_to=slot.l_pad)])
        res["shard_" + name] = np.stack(steps)
        info["shard"][name] = {
            "per_replica": slot.state_bytes_per_replica,
            "total": slot.state_bytes_total,
            "round_trip": bool(np.array_equal(again.float().numpy(), last))}

    # the Gluon Trainer over dist_sync: the sharded update, then 2-bit
    n = len(x["net_y"]) // WORLD
    xs = nd.array(x["net_x"][rank * n:(rank + 1) * n])
    ys = nd.array(x["net_y"][rank * n:(rank + 1) * n])
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def net_and_trainer(store, **kw):
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(6, in_units=5, activation="relu"),
                mt.gluon.nn.Dense(3, in_units=6))
        net.initialize()
        for p, key in zip(net.collect_params().values(),
                          ("net_w1", "net_b1", "net_w2", "net_b2")):
            p.set_data(nd.array(x[key]))
        return net, mt.gluon.Trainer(net.collect_params(), "sgd",
                                     dict(TRAIN_OPT), kvstore=store, **kw)

    def step(net, trainer):
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        trainer.step(len(x["net_y"]))

    def weights(net):
        return [p.data().asnumpy() for p in net.collect_params().values()]

    net, trainer = net_and_trainer(
        mt.kvstore.create("dist_sync", shard_update=True))
    for s in range(TRAIN_STEPS):
        step(net, trainer)
    for i, w in enumerate(weights(net)):
        res["trainer%d" % i] = w
    info["trainer"] = {"update_on_kvstore": trainer._update_on_kvstore,
                       "stats": dict(trainer._kvstore.dispatch_stats)}
    fname = str(path / ("states.r%d" % rank))
    trainer.save_states(fname)
    info["trainer"]["payload"] = next(
        k for k in pickle.load(open(fname, "rb")) if k.startswith("__"))
    saved = weights(net)
    step(net, trainer)
    want = weights(net)
    net2, trainer2 = net_and_trainer(
        mt.kvstore.create("dist_sync", shard_update=True))
    for p, w in zip(net2.collect_params().values(), saved):
        p.set_data(nd.array(w))
    trainer2.load_states(fname)
    step(net2, trainer2)
    info["trainer"]["resumed_equal"] = all(
        np.array_equal(a, b) for a, b in zip(weights(net2), want))

    net, trainer = net_and_trainer("dist_sync",
                                   compression_params=COMPRESSION)
    for s in range(TRAIN_STEPS):
        step(net, trainer)
    for i, w in enumerate(weights(net)):
        res["trainer_2bit%d" % i] = w
    info["trainer_2bit"] = {"update_on_kvstore": trainer._update_on_kvstore}

    # SyncBatchNorm on this rank's quarter of the global batch
    m = 2
    d = nd.array(x["bn_x"][rank * m:(rank + 1) * m])
    g, b = nd.array(x["bn_gamma"]), nd.array(x["bn_beta"])
    for v in (d, g, b):
        v.attach_grad()
    with mt.autograd.record():
        out, mean, var = nd._contrib_SyncBatchNorm(
            d, g, b, nd.array(x["bn_mm"]), nd.array(x["bn_mv"]),
            fix_gamma=False, is_train=True, output_mean_var=True, **BN)
        loss = (out * nd.array(x["bn_dy"][rank * m:(rank + 1) * m])).sum()
    loss.backward()
    res.update(bn_out=out.asnumpy(), bn_mean=mean.asnumpy(),
               bn_var=var.asnumpy(), bn_dx=d.grad.asnumpy(),
               bn_dg=g.grad.asnumpy(), bn_db=b.grad.asnumpy())

    # Module.fit through dist_sync on this rank's quarter: two batches
    it = mt.io.NDArrayIter(x["net_x"][rank * n:(rank + 1) * n],
                           x["net_y"][rank * n:(rank + 1) * n],
                           batch_size=n // 2, label_name="softmax_label")
    mod = mt.mod.Module(_mlp(mt), context=ctx)
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(TRAIN_OPT),
            arg_params={k: nd.array(v) for k, v in _module_params(x).items()})
    for k, v in mod.get_params()[0].items():
        res["module_" + k] = v.asnumpy()
    info["module"] = {"update_on_kvstore": mod._update_on_kvstore,
                      "rescale_grad": mod._optimizer.rescale_grad}

    np.savez(path / ("r%d.npz" % rank), **res)
    info["jax_loaded"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "mxnet_tpu"))
    (path / ("info.r%d.json" % rank)).write_text(json.dumps(info))
    assert not info["jax_loaded"], info["jax_loaded"]
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
