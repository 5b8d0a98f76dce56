"""The transformer under a mesh in a real 4-rank world: training steps
under dp2 x sp2 (ring attention, and without it: the sequence gathered
over sp, through the plain attention and through the flash route's
autograd function), dp2 x tp2 (GQA), ep2 x tp2 (MoE), pp2 x sp2 (RoPE,
the pipeline's ticks with the ring inside a stage) and tp2 with
``remat_layers``, the finite guard with one rank's batch
poisoned, the bucketed all-reduce, each differentiable collective's
gradient, and ``generate`` / ``beam_search`` under dp2 x tp2 (with an
int8 KV cache, and on an int8 weight tree). Each rank is a process on
the CPU, joined over gloo.

A module fixture writes the inputs as .npy files and starts the world
once: this file run as a script, once per rank, joined through a
FileStore under the fixture's directory. While the ranks run, the parent
computes the references: the JAX package's train steps on 4 of the
virtual CPU devices under the same mesh (pp2 x sp2 against JAX's
unsharded step, as tests/test_parallel.py holds it), JAX's unsharded
``generate`` and ``beam_search``, and the collectives' gradients of the
global program in numpy. A rank imports torch and the port only, and
asserts that JAX is not loaded; it writes its block of every parameter,
its momentum and its results, and the tests slice JAX's global arrays to
each rank's block (``param_specs``, the rank's coordinates). A rank
that fails fails the fixture; a world that has not finished within
WORLD_TIMEOUT seconds is killed and fails it too. A host whose loopback
interface gloo does not pick may need GLOO_SOCKET_IFNAME=lo.

The momentum after the first step is that step's gradient (m = 0.9 * 0
+ g), so it holds the gradients. Tolerances: fp32 rtol = atol = 2e-4
for gradients and parameters in every case (the MoE one too, which
tests/test_parallel.py allows 2e-3), 1e-5 relative for losses, beam
scores at tests/test_torch_beam.py's bounds; token streams and the
bucketed all-reduce exact.
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
TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 1e-5
LR = 0.1
STEPS = 2
V = 64
BASE = dict(vocab_size=V, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_len=16)
# name -> (config, mesh axes in order); JAX runs the same mesh, except
# pp2_sp2, held against JAX's unsharded step without ring attention
TRAIN = {
    "dp2_sp2": (dict(BASE, rope=True),
                {"dp": 2, "tp": 1, "sp": 2, "ep": 1}),
    "dp2_sp2_gather": (dict(BASE, rope=True, use_ring_attention=False),
                       {"dp": 2, "tp": 1, "sp": 2, "ep": 1}),
    "dp2_tp2": (dict(BASE, n_kv_heads=2),
                {"dp": 2, "tp": 2, "sp": 1, "ep": 1}),
    "ep2_tp2": (dict(BASE, n_experts=4),
                {"ep": 2, "tp": 2, "dp": 1, "sp": 1}),
    "pp2_sp2": (dict(BASE, n_layers=4, rope=True, pp_axis="pp"),
                {"pp": 2, "dp": 1, "sp": 2}),
}
# port-only runs held against a reference above, as (reference, config
# changes): remat under tp2 against dp2_tp2's (the same numbers,
# recomputed), and the gathered sequence through the flash route's
# autograd function (on the CPU its plain forward and backward) against
# dp2_sp2_gather's
PORT_ONLY = {"remat_tp2": ("dp2_tp2", dict(remat_layers=True)),
             "dp2_sp2_gather_flash": ("dp2_sp2_gather",
                                      dict(use_flash_kernel=True))}
SERVE_MESH = {"dp": 2, "tp": 2}
SERVE = {"fp": dict(BASE, n_kv_heads=2, max_len=32),
         "int8_kv": dict(BASE, n_kv_heads=2, max_len=32, kv_cache_int8=True),
         "q8": dict(BASE, n_kv_heads=2, max_len=32, rope=True)}
GEN_NEW, BEAM, BEAM_NEW = 8, 3, 6


def _inputs():
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, V - 1, (4, 16)).astype(np.int32)
    poisoned = tokens.copy()
    poisoned[3, 5] = V - 1              # only dp rank 1's rows hold it
    return {
        "tokens": tokens, "poisoned": poisoned,
        "prompt": rng.randint(0, V, (4, 6)).astype(np.int32),
        "beam_prompt": rng.randint(0, V, (2, 5)).astype(np.int32),
        "coll_x": rng.randn(WORLD, 8).astype(np.float32),
        "coll_w": rng.randn(WORLD, 8 * WORLD).astype(np.float32),
    }


# ------------------------------------------------------------- parent ---

def _jax_train(name, x):
    """JAX's losses, first momentum (the gradient) and params / momentum
    after STEPS steps, as {leaf name: global array}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxnet_tpu.models import transformer as T
    from mxnet_tpu.parallel import make_mesh
    from mxnet_tpu_torch.models.transformer import flatten_tree

    kw, axes = TRAIN[name]
    toks = jnp.asarray(x["tokens"])
    if name == "pp2_sp2":
        cfg = T.TransformerConfig(**dict(kw, pp_axis=None,
                                         use_ring_attention=False))
        params = T.init_params(cfg, seed=3)
        step = T.make_train_step(cfg, lr=LR)
    else:
        cfg = T.TransformerConfig(**kw)
        mesh = make_mesh(axes, devices=jax.devices()[:WORLD])
        params = T.shard_params(T.init_params(cfg, seed=3), cfg, mesh)
        toks = jax.device_put(toks, NamedSharding(mesh, P("dp", None)))
        step = T.make_train_step(cfg, mesh, lr=LR)
    mom = T.init_momentum(params)
    out = {"loss": []}
    for i in range(STEPS):
        params, mom, loss = step(params, mom, toks)
        out["loss"].append(float(loss))
        if i == 0:
            out["m1"] = {k: np.asarray(v) for k, v in
                         flatten_tree(jax.tree.map(np.asarray, mom)).items()}
    out["p"] = flatten_tree(jax.tree.map(np.asarray, params))
    out["m"] = flatten_tree(jax.tree.map(np.asarray, mom))
    return out


def _jax_serve(x):
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer as T
    out = {}
    for name, kw in SERVE.items():
        cfg = T.TransformerConfig(**kw)
        params = T.init_params(cfg, seed=5)
        if name == "q8":
            params = T.quantize_weights_int8(params)
        out["gen_" + name] = np.asarray(
            T.generate(params, jnp.asarray(x["prompt"]), GEN_NEW, cfg))
        if name != "q8":
            seqs, scores = T.beam_search(params, jnp.asarray(x["beam_prompt"]),
                                         BEAM_NEW, cfg, beam=BEAM)
            out["beam_" + name] = (np.asarray(seqs), np.asarray(scores))
    return out


def _collective_grads(x):
    """The gradients of each collective's global program: every rank r
    holds x[r] and w[r], and the loss sums sum(w[r] * y_r) over ranks."""
    xs, ws = x["coll_x"], x["coll_w"]
    n, k = xs.shape
    out = {}
    out["all_reduce"] = [ws[r, :k] for r in range(n)]
    out["all_gather"] = [ws.sum(0)[r * k:(r + 1) * k] for r in range(n)]
    out["reduce_scatter"] = [np.concatenate([ws[s, :k // n]
                                             for s in range(n)])
                             for _ in range(n)]
    out["ring_permute"] = [ws[(r + 1) % n, :k] for r in range(n)]
    out["pvary"] = [ws[:, :k].sum(0) for _ in range(n)]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(directory, references): the world has run and written each rank's
    results there."""
    path = tmp_path_factory.mktemp("mesh_world")
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
        # the references, while the ranks run
        refs = {name: _jax_train(name, x) for name in TRAIN}
        refs.update(_jax_serve(x))
        refs["grads"] = _collective_grads(x)
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


def _coords(axes, rank):
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def _block(arr, spec, axes, coords):
    """This rank's block of a global array under a partition spec."""
    for dim, name in enumerate(spec):
        if name is not None and axes.get(name, 1) > 1:
            size = arr.shape[dim] // axes[name]
            arr = np.take(arr, range(coords[name] * size,
                                     (coords[name] + 1) * size), axis=dim)
    return arr


def _global_name(name, kw, axes, coords):
    """The JAX tree's leaf of a rank's parameter: under pp a rank's layer
    i is its stage's i-th."""
    parts = name.split(".")
    if parts[0] == "layers" and axes.get("pp", 1) > 1:
        per = kw["n_layers"] // axes["pp"]
        parts[1] = str(int(parts[1]) + coords["pp"] * per)
    return ".".join(parts)


def _check_tree(got, want, kw, axes, coords, tol, what):
    from mxnet_tpu_torch.models import transformer as ttf
    specs = ttf.flatten_tree(ttf.param_specs(ttf.TransformerConfig(**kw)))
    assert got, what
    for name, arr in got.items():
        full = _global_name(name, kw, axes, coords)
        spec_name = ".".join(full.split(".")[:1] + ["0"]
                             + full.split(".")[2:]) \
            if full.startswith("layers.") else full
        np.testing.assert_allclose(
            arr, _block(want[full], specs[spec_name], axes, coords),
            err_msg="%s %s" % (what, name), **tol)


def _rank_results(path, case, rank):
    data = np.load(path / ("%s.r%d.npz" % (case, rank)))
    out = {"loss": data["loss"]}
    for key in ("p", "m", "m1"):
        out[key] = {k[len(key) + 1:]: data[k] for k in data.files
                    if k.startswith(key + ":")}
    return out


@pytest.mark.parametrize("case", list(TRAIN) + list(PORT_ONLY))
def test_train_steps_match_jax(world, case):
    """Every rank's losses, its block of the gradients (the first
    momentum), and its parameters and momentum after the steps are JAX's
    at the stated tolerances."""
    path, refs = world
    ref_case = PORT_ONLY[case][0] if case in PORT_ONLY else case
    kw, axes = TRAIN[ref_case]
    ref = refs[ref_case]
    for rank in range(WORLD):
        got = _rank_results(path, case, rank)
        coords = _coords(axes, rank)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        for key in ("m1", "p", "m"):
            _check_tree(got[key], ref[key], kw, axes, coords, TOL,
                        "%s rank %d %s" % (case, rank, key))


def test_guard_skips_on_every_rank(world):
    """One rank's batch holds a token whose embedding is NaN: the
    all-reduced flag makes every rank skip, and every rank's parameters
    and momentum stay as they were, bitwise."""
    path, _ = world
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert info["guard"] == {"skipped": True, "params_kept": True,
                                 "momentum_kept": True, "loss_finite": False}


def test_whole_params_under_tp_are_refused(world):
    """A rank given the whole parameters under tp (not its heads) would
    count every head twice: the model functions refuse them."""
    path, _ = world
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert "shard_params" in info["whole_params"]


def test_bucketed_all_reduce_is_bitwise_per_key(world):
    path, _ = world
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert info["buckets"]["equal"] is True
        assert info["buckets"]["lanes"] > info["buckets"]["buckets"] > 1


@pytest.mark.parametrize("name", ["all_reduce", "all_gather",
                                  "reduce_scatter", "ring_permute", "pvary"])
def test_collective_gradients(world, name):
    """Each collective's backward gives every rank the gradient of the
    global program (the sum over ranks of each rank's loss)."""
    path, refs = world
    for rank in range(WORLD):
        got = np.load(path / ("grad_%s.r%d.npy" % (name, rank)))
        np.testing.assert_allclose(got, refs["grads"][name][rank],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(SERVE))
def test_generate_dp2_tp2_matches_jax(world, name):
    """generate(mesh=) under dp2 x tp2: every rank returns the global
    tokens, JAX's token for token."""
    path, refs = world
    for rank in range(WORLD):
        got = np.load(path / ("gen_%s.r%d.npy" % (name, rank)))
        np.testing.assert_array_equal(got, refs["gen_" + name])


@pytest.mark.parametrize("name", ["fp", "int8_kv"])
def test_beam_search_dp2_tp2_matches_jax(world, name):
    path, refs = world
    seqs, scores = refs["beam_" + name]
    # tests/test_torch_beam.py's bounds: 1e-5, and ten int8 steps' 1e-4
    atol = 1e-3 if name == "int8_kv" else 1e-5
    for rank in range(WORLD):
        got = np.load(path / ("beam_%s.r%d.npz" % (name, rank)))
        np.testing.assert_array_equal(got["seqs"], seqs)
        np.testing.assert_allclose(got["scores"], scores, rtol=0, atol=atol)


def test_shard_and_replicate(world):
    """shard gives each rank its block of a global tensor under a
    partition spec; replicate gives every rank rank 0's value."""
    path, _ = world
    whole = np.arange(24.0).reshape(8, 3)
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert info["placement"]["replicate"] == [0.0] * 3
        np.testing.assert_array_equal(info["placement"]["shard"],
                                      whole[2 * rank:2 * rank + 2])


def test_ranks_load_no_jax(world):
    path, _ = world
    for rank in range(WORLD):
        info = json.loads((path / ("info.r%d.json" % rank)).read_text())
        assert info["jax_loaded"] == [] and info["device_count"] == WORLD


# -------------------------------------------------------------- a rank ---

def _rank_main(rank, path):
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import transformer as tf

    torch.set_num_threads(1)
    path = Path(path)
    parallel.init_distributed("file://" + str(path / "store"), WORLD, rank)
    x = {n: np.load(path / (n + ".npy")) for n in _inputs()}
    info = {}

    def train(case, kw, axes, steps=STEPS):
        cfg = tf.TransformerConfig(**kw)
        mesh = parallel.make_mesh(axes, device="cpu")
        params = tf.shard_params(tf.init_params(cfg, seed=3, device="cpu"),
                                 cfg, mesh)
        mom = tf.init_momentum(params)
        step = tf.make_train_step(cfg, mesh, lr=LR)
        out, losses = {}, []
        for i in range(steps):
            losses.append(float(step(params, mom, x["tokens"])[2]))
            if i == 0:
                out.update(("m1:" + n, m.numpy().copy())
                           for n, m in mom.items())
        out.update(("p:" + n, p.numpy()) for n, p in
                   params.named_parameters())
        out.update(("m:" + n, m.numpy()) for n, m in mom.items())
        np.savez(path / ("%s.r%d.npz" % (case, rank)), loss=losses, **out)

    for case, (kw, axes) in TRAIN.items():
        train(case, kw, axes)
    for case, (ref_case, change) in PORT_ONLY.items():
        kw, axes = TRAIN[ref_case]
        train(case, dict(kw, **change), axes)

    # the guard: token V - 1 (only in dp rank 1's rows) embeds to NaN
    kw, axes = TRAIN["dp2_tp2"]
    cfg = tf.TransformerConfig(**kw)
    mesh = parallel.make_mesh(axes, device="cpu")
    whole = tf.init_params(cfg, seed=3, device="cpu")
    try:
        tf.loss_fn(whole, x["tokens"], cfg, mesh)
        info["whole_params"] = "ran"
    except ValueError as exc:
        info["whole_params"] = str(exc)
    params = tf.shard_params(tf.init_params(cfg, seed=3, device="cpu"),
                             cfg, mesh)
    params.embed[V - 1] = float("nan")
    mom = {n: torch.full_like(m, 0.5) for n, m in
           tf.init_momentum(params).items()}
    before = [p.clone() for p in params.parameters()]
    _, _, loss, skipped = tf.make_train_step(cfg, mesh, lr=LR, guard=True)(
        params, mom, x["poisoned"])
    info["guard"] = {
        "skipped": bool(skipped),
        "params_kept": all(torch.allclose(a, b, rtol=0, atol=0,
                                          equal_nan=True)
                           for a, b in zip(before, params.parameters())),
        "momentum_kept": all(bool((m == 0.5).all()) for m in mom.values()),
        "loss_finite": bool(torch.isfinite(loss))}

    # the bucketed all-reduce against the per-key one, bitwise
    dpsp = parallel.make_mesh({"dp": 2, "sp": 2}, device="cpu")
    gen = torch.Generator().manual_seed(rank)
    xs = [torch.randn(shape, generator=gen).to(dtype) for shape, dtype in
          (((40, 10), torch.float32), ((7,), torch.bfloat16),
           ((300, 4), torch.float32), ((3,), torch.float32),
           ((16, 16), torch.bfloat16), ((), torch.float32))]
    fused = parallel.bucketed_all_reduce(xs, ("dp", "sp"), max_bytes=1024,
                                         mesh=dpsp)
    keyed = [parallel.all_reduce(t, ("dp", "sp"), mesh=dpsp) for t in xs]
    plan = parallel.fusion.plan_buckets([(i, tuple(t.shape), t.dtype)
                                         for i, t in enumerate(xs)], 1024)
    info["buckets"] = {
        "equal": all(a.dtype == b.dtype and torch.equal(a, b)
                     for a, b in zip(fused, keyed)),
        "buckets": len(plan), "lanes": sum(len(b.lanes) for b in plan)}

    # each collective's gradient, over a 4-rank axis
    sp4 = parallel.make_mesh({"sp": 4}, device="cpu")
    block = parallel.shard(torch.arange(24.0).reshape(8, 3),
                           parallel.P("sp", None), mesh=sp4)
    info["placement"] = {
        "replicate": parallel.replicate(torch.full((3,), float(rank)),
                                        mesh=sp4).tolist(),
        "shard": block.tolist()}
    w = torch.from_numpy(x["coll_w"][rank])
    k = x["coll_x"].shape[1]
    runs = {
        "all_reduce": lambda t: parallel.all_reduce(t, "sp", mesh=sp4)
        @ w[:k],
        "all_gather": lambda t: parallel.all_gather(t, "sp", mesh=sp4) @ w,
        "reduce_scatter": lambda t: parallel.reduce_scatter(
            t, "sp", mesh=sp4) @ w[:k // WORLD],
        "ring_permute": lambda t: parallel.ring_permute(t, "sp", mesh=sp4)
        @ w[:k],
        "pvary": lambda t: parallel.pvary(t, "sp", mesh=sp4) @ w[:k],
    }
    for name, run in runs.items():
        t = torch.from_numpy(x["coll_x"][0 if name == "pvary" else rank]
                             ).requires_grad_(True)
        run(t).backward()
        np.save(path / ("grad_%s.r%d.npy" % (name, rank)), t.grad.numpy())

    # generate and beam search under dp2 x tp2
    mesh = parallel.make_mesh(SERVE_MESH, device="cpu")
    for name, kw in SERVE.items():
        cfg = tf.TransformerConfig(**kw)
        params = tf.init_params(cfg, seed=5, device="cpu")
        if name == "q8":
            params = tf.quantize_weights_int8(params)
        params = tf.shard_params(params, cfg, mesh)
        np.save(path / ("gen_%s.r%d.npy" % (name, rank)),
                tf.generate(params, x["prompt"], GEN_NEW, cfg,
                            mesh=mesh).numpy())
        if name != "q8":
            seqs, scores = tf.beam_search(params, x["beam_prompt"], BEAM_NEW,
                                          cfg, beam=BEAM, mesh=mesh)
            np.savez(path / ("beam_%s.r%d.npz" % (name, rank)),
                     seqs=seqs.numpy(), scores=scores.numpy())

    info.update(jax_loaded=sorted(m for m in sys.modules
                                  if m.split(".")[0] in ("jax", "mxnet_tpu")),
                device_count=parallel.device_count())
    (path / ("info.r%d.json" % rank)).write_text(json.dumps(info))
    assert not info["jax_loaded"], info["jax_loaded"]
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
