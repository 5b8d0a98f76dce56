"""The port's bucket planner and lane packing (``parallel/fusion.py``)
held against the JAX package's on the CPU: the same
entries (mixed float32, bfloat16 and int32 keys, one larger than a
bucket, arrays past the bigarray bound) give the same plan, the same
signature, and packed and unpacked lanes of the same values. The port
takes the JAX package's ``MXNET_KVSTORE_BUCKET_BYTES`` and
``MXNET_KVSTORE_BIGARRAY_BOUND`` as the ``max_bytes`` and
``bigarray_bound`` arguments; JAX reads the bound from the environment,
set here per case. The 4-rank all-reduce is held bitwise against the
per-key one in tests/test_torch_mesh_world.py, the sharded update
(``ShardSlot``) against JAX's in tests/test_torch_kvstore_world.py.
Tolerance: exact."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch import cpu as mt_cpu
from mxnet_tpu_torch import ndarray as mt_nd
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import fusion
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfusion = importlib.import_module("mxnet_tpu.parallel.fusion")

# (key, shape, dtype name): a mixed-dtype stack with a key larger than a
# 1 KB bucket (w_big, 2 KB) and scalars
ENTRIES = (("w0", (8, 4), "float32"), ("b0", (4,), "float32"),
           ("e", (16, 4), "bfloat16"), ("w_big", (32, 16), "float32"),
           ("n", (3,), "int32"), ("g", (), "float32"),
           ("w1", (4, 4), "bfloat16"), ("b1", (4,), "float32"),
           ("h", (40,), "float32"), ("w2", (10, 10), "float32"))
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int32": torch.int32}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "int32": jnp.int32}
# (max_bytes, bigarray bound in elements): a small bucket, one holding
# everything, and a bound under w_big and w2 so they travel alone
CASES = ((1024, 1_000_000), (1 << 20, 1_000_000), (512, 64))


def _plan_tuple(plan):
    return [(b.index, b.nbytes,
             [(lane.dtype, lane.size, lane.nbytes,
               [(s.key, s.shape, s.dtype, s.size, s.offset)
                for s in lane.segments]) for lane in b.lanes])
            for b in plan]


def _values(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for key, shape, dt in ENTRIES:
        arr = np.asarray(rng.randn(*shape) * 10)
        out[key] = arr.astype(np.int32) if dt == "int32" else \
            arr.astype(np.float32)
    return out


@pytest.mark.parametrize("max_bytes, bound", CASES)
def test_plan_and_signature_match_jax(monkeypatch, max_bytes, bound):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", str(bound))
    jplan = jfusion.plan_buckets(
        [(k, s, JNP[d]) for k, s, d in ENTRIES], max_bytes)
    for dtypes in (TORCH, {d: d for d in TORCH}):     # torch dtypes or names
        entries = [(k, s, dtypes[d]) for k, s, d in ENTRIES]
        plan = fusion.plan_buckets(entries, max_bytes, bigarray_bound=bound)
        assert _plan_tuple(plan) == _plan_tuple(jplan)
        assert fusion.plan_signature(entries, max_bytes, bound) == \
            jfusion.plan_signature([(k, s, JNP[d]) for k, s, d in ENTRIES],
                                   max_bytes)
    # lanes never mix dtypes, and every key lands in exactly one segment
    keys = [s.key for b in plan for lane in b.lanes for s in lane.segments]
    assert sorted(keys) == sorted(k for k, _, _ in ENTRIES)
    for b in plan:
        assert len({lane.dtype for lane in b.lanes}) == len(b.lanes)


@pytest.mark.parametrize("max_bytes, bound", CASES)
def test_pack_and_unpack_match_jax(monkeypatch, max_bytes, bound):
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", str(bound))
    vals = _values()
    tvals = {k: torch.from_numpy(vals[k]).to(TORCH[d])
             for k, _, d in ENTRIES}
    jvals = {k: jnp.asarray(vals[k], JNP[d]) for k, _, d in ENTRIES}
    plan = fusion.plan_buckets([(k, s, TORCH[d]) for k, s, d in ENTRIES],
                               max_bytes, bigarray_bound=bound)
    jplan = jfusion.plan_buckets([(k, s, JNP[d]) for k, s, d in ENTRIES],
                                 max_bytes)
    for bucket, jbucket in zip(plan, jplan):
        for lane, jlane in zip(bucket.lanes, jbucket.lanes):
            flat = fusion.pack_lane(lane, tvals)
            jflat = jfusion.pack_lane(jlane, jvals)
            assert flat.dtype == TORCH[lane.dtype]
            np.testing.assert_array_equal(
                flat.float().numpy(), np.asarray(jflat, np.float32))
            back = fusion.unpack_lane(fusion.pack_lane(lane, tvals), lane)
            jback = jfusion.unpack_lane(jfusion.pack_lane(jlane, jvals),
                                        jlane)
            assert set(back) == set(jback)
            for key, t in back.items():
                assert torch.equal(t, tvals[key])
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(jback[key], np.float32))


def test_bucketed_all_reduce_world_of_one_and_store_refusals():
    """At a world of one each lane's all-reduce is the identity, so the
    bucketed all-reduce gives back every tensor bitwise, in input order
    and dtype. The store's switches, which named A7 until the kvstore
    came, now answer with the JAX package's defaults or the override;
    FlatOptimizer takes sgd, nag and adam and refuses a subclass or
    another rule; a ShardSlot on a world of one updates the whole flat
    lane as the optimizer updates each key, and pack_lane pads it."""
    from mxnet_tpu_torch import optimizer as topt
    mesh = parallel.make_mesh({"dp": 1, "sp": 1}, device="cpu")
    vals = _values(1)
    xs = [torch.from_numpy(vals[k]).to(TORCH[d]) for k, _, d in ENTRIES]
    got = parallel.bucketed_all_reduce(xs, ("dp", "sp"), max_bytes=256,
                                       mesh=mesh)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, xs))
    assert fusion.bucket_bytes() == fusion.DEFAULT_BUCKET_BYTES == 25 << 20
    assert (fusion.fusion_enabled(), fusion.shard_update_enabled(),
            fusion.bigarray_bound()) == (True, False, 1_000_000) == \
        (jfusion.fusion_enabled(), jfusion.shard_update_enabled(),
         jfusion.bigarray_bound())
    assert (fusion.fusion_enabled(False), fusion.shard_update_enabled(True),
            fusion.bigarray_bound(64)) == (False, True, 64)
    for name in ("sgd", "nag", "adam"):
        assert fusion.FlatOptimizer.supports(topt.create(name)).name == name

    class MySGD(topt.SGD):
        pass
    for opt in (MySGD(), topt.create("rmsprop"), None):
        assert fusion.FlatOptimizer.supports(opt) is None
    opt = topt.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-3,
                      rescale_grad=0.5)
    flat = fusion.FlatOptimizer.supports(opt)
    assert flat.n_states == 1
    plan = fusion.plan_buckets([("0", (3, 2), "float32"),
                                ("1", (5,), "float32")])
    lane = plan[0].lanes[0]
    w = {"0": torch.arange(6.0).reshape(3, 2), "1": torch.ones(5)}
    slot = fusion.ShardSlot(lane, None, w, flat)
    assert (slot.n, slot.l_pad, slot.state_bytes_per_replica) == (1, 11, 44)
    g = {"0": torch.full((3, 2), 0.5), "1": torch.arange(5.0)}
    padded = fusion.pack_lane(lane, g, pad_to=13)
    assert padded.shape == (13,) and not padded[11:].any()
    new = fusion.unpack_lane(slot.step([fusion.pack_lane(lane, g)]), lane)
    updater = topt.get_updater(topt.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3, rescale_grad=0.5))
    for k in ("0", "1"):
        ref = mt_nd.array(w[k].numpy(), ctx=mt_cpu())
        updater(int(k), mt_nd.array(g[k].numpy(), ctx=mt_cpu()), ref)
        assert torch.equal(new[k], ref._data)
