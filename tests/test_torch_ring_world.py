"""The port's parallel slice in a real 4-rank world: ring attention, the
transformer's forward and loss under sp = 4 and dp = 2 x sp = 2, the
sequence-parallel decode and the collectives, each rank a process on the
CPU joined over gloo, held against the JAX package on 4 of the virtual
CPU devices at the tolerances of tests/test_parallel.py.

A module fixture computes the JAX references (the Pallas carry kernel in
interpret mode, on a mesh of the sp axis alone) and writes them with the
inputs as .npy files, then starts the world once: this file run as a
script, once per rank, joined through a FileStore under the fixture's
directory. A rank imports torch and the port only, and asserts that JAX
is not loaded; it writes what it computes as .npy files, and the tests
compare them. A rank that fails fails the fixture; a world that has not
finished within WORLD_TIMEOUT seconds is killed and fails it too. Run
here without a GPU; a host without a loopback interface gloo picks may
need GLOO_SOCKET_IFNAME=lo.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
WORLD_TIMEOUT = 120
RING = dict(rtol=1e-4, atol=1e-5)       # test_ring_attention_matches_reference
MODEL = dict(rtol=2e-4, atol=2e-4)      # test_rope_ring_matches_single_device
DECODE = dict(rtol=2e-4, atol=2e-5)     # test_sp_flash_decode_*
# the RoPE model of test_rope_ring_matches_single_device, at sp = 4
ROPE_CFG = dict(vocab_size=31, d_model=32, n_heads=4, n_layers=2, d_ff=48,
                max_len=32, rope=True)
# a learned-position GQA model for dp = 2 x sp = 2
DPSP_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
                n_layers=2, d_ff=64, max_len=32)


def _inputs():
    """Every input of the world's checks, from one numpy seed."""
    rng = np.random.RandomState(7)
    f32 = np.float32
    return {
        "qkv": rng.randn(3, 2, 64, 2, 16).astype(f32),
        "rope_tokens": rng.randint(0, 31, (2, 32)).astype(np.int32),
        "dpsp_tokens": rng.randint(0, 64, (4, 32)).astype(np.int32),
        # decode: lengths end inside a shard, fill the cache, and are 0
        "dec_q": rng.randn(4, 4, 16).astype(f32),
        "dec_k": rng.randn(4, 64, 2, 16).astype(f32),
        "dec_v": rng.randn(4, 64, 2, 16).astype(f32),
        "dec_len": np.array([5, 64, 0, 37], np.int32),
    }


# ------------------------------------------------------------- parent ---

def _references(x):
    """The JAX package's results on the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxnet_tpu.models import transformer as T
    from mxnet_tpu.parallel import make_mesh
    from mxnet_tpu.parallel.ring import ring_attention_sharded, \
        sp_flash_decode

    devs = jax.devices()[:WORLD]
    sp4 = make_mesh({"sp": 4}, devices=devs)
    out = {}
    q, k, v = (jnp.asarray(a) for a in x["qkv"])
    for causal in (True, False):
        for flash in (False, True):
            out["ring_c%d_f%d" % (causal, flash)] = ring_attention_sharded(
                q, k, v, sp4, causal=causal, use_flash_kernel=flash)

    cfg = T.TransformerConfig(**ROPE_CFG)
    params = T.init_params(cfg, seed=25)
    toks = jnp.asarray(x["rope_tokens"])
    out["rope_single"] = T.forward(params, toks, cfg)
    mesh = make_mesh({"dp": 1, "tp": 1, "sp": 4, "ep": 1}, devices=devs)
    out["rope_sp4"] = T.forward(
        T.shard_params(params, cfg, mesh),
        jax.device_put(toks, NamedSharding(mesh, P(None, None))), cfg, mesh)

    cfg = T.TransformerConfig(**DPSP_CFG)
    params = T.init_params(cfg, seed=27)
    mesh = make_mesh({"dp": 2, "tp": 1, "sp": 2, "ep": 1}, devices=devs)
    sharded = T.shard_params(params, cfg, mesh)
    toks = jax.device_put(jnp.asarray(x["dpsp_tokens"]),
                          NamedSharding(mesh, P("dp", None)))
    out["dpsp_logits"] = T.forward(sharded, toks, cfg, mesh)
    out["dpsp_loss"] = T.loss_fn(sharded, toks, cfg, mesh)

    dec = [jnp.asarray(x[n]) for n in ("dec_q", "dec_k", "dec_v", "dec_len")]
    out["decode_sp4"] = sp_flash_decode(*dec, sp4)
    dpsp = make_mesh({"dp": 2, "sp": 2}, devices=devs)
    out["decode_dp2_sp2"] = sp_flash_decode(*dec, dpsp, batch_axis="dp")
    return {n: np.asarray(a) for n, a in out.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(directory, JAX references): the world has run and written each
    rank's results there."""
    path = tmp_path_factory.mktemp("ring_world")
    x = _inputs()
    for name, arr in x.items():
        np.save(path / (name + ".npy"), arr)
    refs = _references(x)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    logs = [open(path / ("rank%d.log" % rank), "w") for rank in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(path)], env=env,
        stdout=log, stderr=subprocess.STDOUT) for rank, log in enumerate(logs)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
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


def _ranks(path, name):
    return [np.load(path / ("%s.r%d.npy" % (name, r))) for r in range(WORLD)]


@pytest.mark.parametrize("flash", [False, True], ids=["jnp", "carry"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_sharded_matches_jax(world, causal, flash):
    path, refs = world
    name = "ring_c%d_f%d" % (causal, flash)
    for got in _ranks(path, name):
        np.testing.assert_allclose(got, refs[name], **RING)


@pytest.mark.parametrize("flash", [False, True], ids=["jnp", "carry"])
def test_rope_forward_sp4_matches_jax(world, flash):
    path, refs = world
    for got in _ranks(path, "rope_f%d" % flash):
        np.testing.assert_allclose(got, refs["rope_sp4"], **MODEL)
        np.testing.assert_allclose(got, refs["rope_single"], **MODEL)


def test_loss_and_forward_dp2_sp2_match_jax(world):
    path, refs = world
    for got in _ranks(path, "dpsp_logits"):
        np.testing.assert_allclose(got, refs["dpsp_logits"], **MODEL)
    losses = _ranks(path, "dpsp_loss")
    assert all(loss == losses[0] for loss in losses)    # one scalar
    np.testing.assert_allclose(losses[0], refs["dpsp_loss"], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("route", ["kernel", "dense"])
@pytest.mark.parametrize("mesh", ["sp4", "dp2_sp2"])
def test_sp_flash_decode_matches_jax(world, mesh, route):
    path, refs = world
    for got in _ranks(path, "decode_%s_%s" % (mesh, route)):
        np.testing.assert_allclose(got, refs["decode_" + mesh], **DECODE)
        np.testing.assert_array_equal(got[2], 0.0)      # the empty row


def test_ring_permute_round_trip(world):
    path, _ = world
    for rank, got in enumerate(_ranks(path, "permuted")):
        assert np.all(got == (rank - 1) % WORLD)


def test_collectives(world):
    path, _ = world
    base = np.arange(8, dtype=np.float32)
    total = sum(base + r for r in range(WORLD))
    for rank in range(WORLD):
        got = {n: np.load(path / ("%s.r%d.npy" % (n, rank)))
               for n in ("sum", "max", "gather", "stack", "scatter")}
        np.testing.assert_array_equal(got["sum"], total)
        np.testing.assert_array_equal(got["max"], base + WORLD - 1)
        np.testing.assert_array_equal(
            got["gather"], np.concatenate([base + r for r in range(WORLD)]))
        assert got["stack"].shape == (WORLD, 8)
        np.testing.assert_array_equal(got["scatter"],
                                      total[2 * rank:2 * rank + 2])


def test_world_refusals_and_isolation(world):
    """No rank loads JAX. What this world's ranks once refused (tp and ep
    above 1, sp without the ring) now runs, and each forward equals the
    unsharded one on every rank at MODEL's tolerance (the mesh-world
    tests hold them against JAX)."""
    path, _ = world
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert info["jax_loaded"] == []
        assert info["device_count"] == WORLD
        for what in ("forward tp2", "forward ep2",
                     "forward sp4 without the ring"):
            assert info["refusals"][what] <= MODEL["atol"], what


# -------------------------------------------------------------- a rank ---

def _rank_main(rank, path):
    """One rank of the world: run every check's port side, save results."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.parallel import ring

    torch.set_num_threads(1)
    path = Path(path)
    parallel.init_distributed("file://" + str(path / "store"), WORLD, rank)
    x = {n: torch.from_numpy(np.load(path / (n + ".npy")))
         for n in _inputs()}

    def save(name, t):
        np.save(path / ("%s.r%d.npy" % (name, rank)),
                t.numpy() if torch.is_tensor(t) else t)

    sp4 = parallel.make_mesh({"sp": 4}, device="cpu")
    base = torch.arange(8, dtype=torch.float32) + rank
    save("sum", parallel.all_reduce(base, "sp", mesh=sp4))
    save("max", parallel.all_reduce(base, "sp", op="max", mesh=sp4))
    save("gather", parallel.all_gather(base, "sp", mesh=sp4))
    save("stack", parallel.all_gather(base, "sp", tiled=False, mesh=sp4))
    save("scatter", parallel.reduce_scatter(base, "sp", mesh=sp4))
    mine = torch.full((3,), float(rank))
    moved = parallel.ring_permute(mine, "sp", mesh=sp4)
    back = parallel.ring_permute(moved, "sp", shift=-1, mesh=sp4)
    assert torch.equal(back, mine)
    save("permuted", moved)

    q, k, v = x["qkv"]
    for causal in (True, False):
        for flash in (False, True):
            save("ring_c%d_f%d" % (causal, flash),
                 ring.ring_attention_sharded(q, k, v, sp4, causal=causal,
                                             use_flash_kernel=flash))

    mesh = parallel.make_mesh({"dp": 1, "sp": 4}, device="cpu")
    for flash in (False, True):
        cfg = tf.TransformerConfig(use_flash_kernel=flash, **ROPE_CFG)
        params = tf.shard_params(tf.init_params(cfg, seed=25, device="cpu"),
                                 cfg, mesh)
        save("rope_f%d" % flash, tf.forward(params, x["rope_tokens"], cfg,
                                            mesh))

    dpsp = parallel.make_mesh({"dp": 2, "sp": 2}, device="cpu")
    cfg = tf.TransformerConfig(use_flash_kernel=True, **DPSP_CFG)
    params = tf.init_params(cfg, seed=27, device="cpu")
    save("dpsp_logits", tf.forward(params, x["dpsp_tokens"], cfg, dpsp))
    save("dpsp_loss", tf.loss_fn(params, x["dpsp_tokens"], cfg, dpsp))

    dec = [x[n] for n in ("dec_q", "dec_k", "dec_v", "dec_len")]
    for route, use_pallas in (("kernel", True), ("dense", False)):
        save("decode_sp4_" + route,
             ring.sp_flash_decode(*dec, sp4, use_pallas=use_pallas))
        save("decode_dp2_sp2_" + route,
             ring.sp_flash_decode(*dec, dpsp, batch_axis="dp",
                                  use_pallas=use_pallas))

    tp = parallel.make_mesh({"dp": 1, "tp": 2, "sp": 2}, device="cpu")
    ep = parallel.make_mesh({"ep": 2, "sp": 2}, device="cpu")
    tokens = x["dpsp_tokens"][:2, :8]
    moe = tf.TransformerConfig(dp_axis=None, **dict(DPSP_CFG, n_experts=2))
    no_ring = tf.TransformerConfig(use_ring_attention=False, **DPSP_CFG)
    refusals = {}
    for what, c, m in (("forward tp2", cfg, tp), ("forward ep2", moe, ep),
                       ("forward sp4 without the ring", no_ring, mesh)):
        whole = tf.init_params(c, seed=27, device="cpu")
        got = tf.forward(tf.shard_params(whole, c, m), tokens, c, m)
        refusals[what] = float((got - tf.forward(whole, tokens, c))
                               .abs().max())
    info = {"jax_loaded": sorted(m for m in sys.modules
                                 if m.split(".")[0] in ("jax", "mxnet_tpu")),
            "device_count": parallel.device_count(), "refusals": refusals}
    (path / ("info.r%d.json" % rank)).write_text(json.dumps(info))
    assert not info["jax_loaded"], info["jax_loaded"]
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
