"""The port's elastic shard sets (``save_shard_checkpoint``,
``load_shard_checkpoint``, ``list_shard_generations``, ``shard_layout``
and ``resume_elastic`` in ``mxnet_tpu_torch/models/checkpoint.py``) held
against the JAX package's on the CPU, at the example's toy config (vocab
41, d_model 16, 2 heads, 1 layer): the layout is JAX's for the same tree;
merge and reshard round trips over worlds 1 -> 4, 4 -> 1, 2 -> 3 and
3 -> 2; the cursor, RNG and metadata survive; an incomplete set and a
mixed one raise naming the ranks or the field; a corrupt rank's
parameters come from another rank and ``allow_partial`` zero-fills
exactly the lost rank's lane slices; retention keeps the newest
generations; ``resume_elastic`` takes the newer state and refuses a
stale generation; and across packages a 4-rank set written by JAX merges
in the port, and one written by the port merges in JAX. Tolerance:
exact everywhere (bytes, steps, records)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import checkpoint as jck
from mxnet_tpu.models import transformer as jtf

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.parallel import elastic
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=32)


def tiny_state(seed=0, dtype=torch.float32):
    cfg = ttf.TransformerConfig(dtype=dtype, **CFG)
    params = ttf.init_params(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(seed + 100)
    mom = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                               .astype(np.float32))
           for n, p in params.named_parameters()}
    return cfg, params, mom


def _same(params, mom, p2, m2):
    named = dict(p2.named_parameters())
    assert sorted(named) == sorted(dict(params.named_parameters()))
    for n, t in params.named_parameters():
        assert named[n].dtype == t.dtype and torch.equal(named[n], t), n
        assert torch.equal(m2[n], mom[n]), n


def _save_set(d, cfg, params, mom, world, generation, step=5, **kw):
    for r in range(world):
        ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=step,
                                 rank=r, world=world, generation=generation,
                                 keep_generations=8, **kw)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


@pytest.mark.parametrize("world", [1, 3, 4])
def test_shard_layout_is_jaxs(world):
    cfg, params, mom = tiny_state()
    jm = jax.tree.map(jnp.asarray, ttf.unflatten_tree(
        {n: t.numpy() for n, t in mom.items()}))
    got = ck.shard_layout(mom, world)
    assert got == jck.shard_layout(jm, world)
    assert got == ck.shard_layout(mom, world)
    assert all(lane["l_pad"] % world == 0 for lane in got["lanes"])
    assert got["signature"] == ck.shard_layout(mom, 2)["signature"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("worlds", [(1, 4), (4, 1), (2, 3), (3, 2)])
def test_merge_reshard_round_trip(tmp_path, worlds, dtype):
    """A set saved at N merges, saves again at N' and merges: parameters
    and momentum bitwise throughout."""
    n, n2 = worlds
    cfg, params, mom = tiny_state(dtype=dtype)
    d = str(tmp_path)
    _save_set(d, cfg, params, mom, n, 1)
    _, p1, m1, step, ex = ck.load_shard_checkpoint(d, device="cpu")
    assert step == 5 and ex["world"] == n
    _same(params, mom, p1, m1)
    _save_set(d, cfg, p1, m1, n2, 2, step=6)
    assert ck.list_shard_generations(d) == [(1, 5, n), (2, 6, n2)]
    _, p2, m2, step2, ex2 = ck.load_shard_checkpoint(d, device="cpu")
    assert step2 == 6 and ex2["world"] == n2 and ex2["generation"] == 2
    _same(params, mom, p2, m2)


def test_cursor_rng_metadata_survive(tmp_path):
    cfg, params, mom = tiny_state()
    d = str(tmp_path)
    rng = elastic.capture_rng()
    cur = {"cursor": 24, "idx": {"__nd__": "int64", "data": list(range(8))}}
    ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=3, rank=0,
                             world=1, generation=0, cursor=cur, rng=rng,
                             base_world=2, metadata={"note": "x"})
    for load in (lambda: ck.load_shard_checkpoint(d, device="cpu"),
                 lambda: jck.load_shard_checkpoint(d)):
        _, _, _, step, ex = load()
        assert step == 3 and ex["cursor"] == cur and ex["rng"] == rng
        assert ex["base_world"] == 2 and ex["metadata"] == {"note": "x"}


def test_incomplete_and_mixed_sets_name_the_rank_or_field(tmp_path):
    cfg, params, mom = tiny_state()
    d = str(tmp_path / "incomplete")
    for r in (0, 2):
        ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=1,
                                 rank=r, world=3, generation=0)
    assert ck.list_shard_generations(d) == []
    with pytest.raises(ck.CheckpointIncompatible, match=r"rank\(s\) \[1\]"):
        ck.load_shard_checkpoint(d, generation=0, device="cpu")
    with pytest.warns(RuntimeWarning, match="missing rank"):
        _, _, m, _, _ = ck.load_shard_checkpoint(
            d, generation=0, allow_partial=True, device="cpu")
    assert m is not None
    d = str(tmp_path / "mixed")
    ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=1, rank=0,
                             world=2, generation=0)
    ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=2, rank=1,
                             world=2, generation=0)
    with pytest.raises(ck.CheckpointIncompatible, match="step"):
        ck.load_shard_checkpoint(d, generation=0, device="cpu")
    with pytest.raises(ck.CheckpointIncompatible, match="no manifests"):
        ck.load_shard_checkpoint(d, generation=7, device="cpu")
    with pytest.raises(FileNotFoundError):
        ck.load_shard_checkpoint(str(tmp_path / "none"), device="cpu")
    with pytest.raises(ValueError, match="outside world"):
        ck.save_shard_checkpoint(d, cfg, params, rank=2, world=2)


def _lane_owner(cfg, mom, world, rank):
    """{name: bool mask} of the momentum elements in ``rank``'s lane
    slices."""
    layout = ck.shard_layout(mom, world)
    out = {n: np.zeros(t.numel(), bool) for n, t in mom.items()}
    for lane in layout["lanes"]:
        n_per = lane["l_pad"] // world
        lo, hi = rank * n_per, (rank + 1) * n_per
        for key, _shape, size, offset in lane["segments"]:
            name = key[len("m."):]
            a, b = max(lo, offset), min(hi, offset + size)
            if a < b:
                out[name][a - offset:b - offset] = True
    return {n: m.reshape(tuple(mom[n].shape)) for n, m in out.items()}


def test_corrupt_rank_falls_back_and_partial_zero_fills(tmp_path):
    """Rank 0's data file torn: the parameters restore from rank 1's copy;
    under allow_partial exactly rank 0's lane slices resume as zeros."""
    cfg, params, mom = tiny_state()
    d = str(tmp_path)
    _save_set(d, cfg, params, mom, 3, 0)
    name = [n for n in os.listdir(d)
            if n.startswith("shard-arrays-g0-r0of3")][0]
    with open(os.path.join(d, name), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef" * 8)
    with pytest.raises(ck.CheckpointCorrupt):
        ck.load_shard_checkpoint(d, generation=0, device="cpu")
    with pytest.warns(RuntimeWarning, match="zero-filling rank 0"):
        _, p2, m2, _, _ = ck.load_shard_checkpoint(
            d, generation=0, allow_partial=True, device="cpu")
    owned = _lane_owner(cfg, mom, 3, 0)
    for n, t in params.named_parameters():
        assert torch.equal(dict(p2.named_parameters())[n], t)
        got, want = m2[n].numpy(), mom[n].numpy()
        assert np.all(got[owned[n]] == 0), n
        np.testing.assert_array_equal(got[~owned[n]], want[~owned[n]])
    assert any(m.any() for m in owned.values())


def test_retention_keeps_newest_generations(tmp_path):
    cfg, params, mom = tiny_state()
    d = str(tmp_path)
    for g in range(4):
        ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=g,
                                 rank=0, world=1, generation=g,
                                 keep_generations=2)
    assert [g for g, _s, _w in ck.list_shard_generations(d)] == [2, 3]
    assert not any(n.startswith(("shard-arrays-g0", "shard-arrays-g1"))
                   for n in os.listdir(d))
    # the default keeps two
    for g in range(4, 7):
        ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=g,
                                 rank=0, world=1, generation=g)
    assert [g for g, _s, _w in ck.list_shard_generations(d)] == [5, 6]


def test_resume_elastic_prefers_newer_and_refuses_stale(tmp_path):
    cfg, params, mom = tiny_state()
    d = str(tmp_path)
    ck.save_checkpoint(d, cfg, params, momentum=mom, step=3)
    ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=5, rank=0,
                             world=1, generation=1, cursor={"cursor": 40})
    _, _, _, step, extras = ck.resume_elastic(d, device="cpu")
    assert step == 5 and extras["cursor"] == {"cursor": 40}
    ck.save_checkpoint(d, cfg, params, momentum=mom, step=9,
                       metadata={"cursor": {"cursor": 8}})
    _, _, _, step, extras = ck.resume_elastic(d, device="cpu")
    assert step == 9 and extras == {"cursor": {"cursor": 8}}
    # an explicit generation pins the shard set
    assert ck.resume_elastic(d, generation=1, device="cpu")[3] == 5
    with pytest.raises(ck.CheckpointIncompatible, match="generation 4"):
        ck.resume_elastic(d, generation=4, device="cpu")
    s = str(tmp_path / "stale")
    ck.save_shard_checkpoint(s, cfg, params, momentum=mom, step=5, rank=0,
                             world=1, generation=6)
    with pytest.raises(ck.CheckpointIncompatible, match="AHEAD"):
        ck.resume_elastic(s, expect_generation=4, device="cpu")
    assert ck.resume_elastic(s, expect_generation=6, device="cpu")[3] == 5
    # a momentum-less set cannot serve another world
    ck.save_shard_checkpoint(s, cfg, params, step=8, rank=0, world=1,
                             generation=7)
    with pytest.raises(ck.CheckpointIncompatible, match="world 2"):
        ck.resume_elastic(s, expect_world=2, device="cpu")
    fresh = ck.resume_elastic(str(tmp_path / "empty"),
                              init=lambda: (cfg, params, mom, 0),
                              device="cpu")
    assert fresh[3] == 0 and fresh[4] == {}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_four_rank_set_crosses_packages(tmp_path, writer):
    """A 4-rank set (each rank the full parameters and its lane slices)
    written by one package merges in the other bitwise, fp32 and bf16
    leaves alike."""
    jcfg = jtf.TransformerConfig(dtype=jnp.bfloat16, **CFG)
    jp = jtf.init_params(jcfg, seed=1)
    rng = np.random.RandomState(7)
    jm = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jp)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    mom = convert.momentum_from_jax(jax.tree.map(np.asarray, jm), params)
    d = str(tmp_path)
    for r in range(4):
        if writer == "jax":
            jck.save_shard_checkpoint(d, jcfg, jp, momentum=jm, step=11,
                                      rank=r, world=4, generation=2,
                                      cursor={"cursor": 8}, base_world=4)
        else:
            ck.save_shard_checkpoint(d, cfg, params, momentum=mom, step=11,
                                     rank=r, world=4, generation=2,
                                     cursor={"cursor": 8}, base_world=4)
    assert ck.list_shard_generations(d) == jck.list_shard_generations(d) \
        == [(2, 11, 4)]
    _, p2, m2, step, ex = ck.load_shard_checkpoint(d, device="cpu")
    assert step == 11 and ex["cursor"] == {"cursor": 8}
    _same(params, mom, p2, m2)
    _, jp2, jm2, jstep, jex = jck.load_shard_checkpoint(d)
    assert jstep == 11 and jex["world"] == 4
    want_p, want_m = ttf.flatten_tree(jp), ttf.flatten_tree(jm)
    got_p, got_m = ttf.flatten_tree(jp2), ttf.flatten_tree(jm2)
    for n in want_p:
        assert np.asarray(got_p[n]).dtype == np.asarray(want_p[n]).dtype
        np.testing.assert_array_equal(np.asarray(got_p[n], np.float32),
                                      np.asarray(want_p[n], np.float32))
        np.testing.assert_array_equal(np.asarray(got_m[n]),
                                      np.asarray(want_m[n]))
