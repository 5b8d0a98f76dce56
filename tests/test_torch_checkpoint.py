"""The port's checkpoints (``mxnet_tpu_torch/models/checkpoint.py``) held
against the JAX package's on the CPU, at a small config (vocab 41,
d_model 16, 2 heads, 1 layer, max_len 32): exact fp32 and bf16 round
trips, the atomic commit and ``keep=N`` retention, corrupt checkpoints
refused by name with the fallback to a retained one, the async save's
barrier (a train step called straight after the save does not reach the
checkpoint), kill -9 mid-save and SIGTERM's emergency save in
subprocesses that import torch and the port only, ``resume_from_latest``
against the uninterrupted run, and the format across packages: a
JAX-written checkpoint loads in the port bitwise with the same
``param_fingerprint``, a port-written one loads in JAX's
``load_checkpoint`` and verifies under both ``verify_lineage``s. The
shard functions work (a shard set round trips and resumes; the rest of
their surface is tests/test_torch_checkpoint_shards.py); ``q8`` trees
load (their round trips across packages are in
tests/test_torch_int8_weights.py). Tolerance: exact everywhere (bytes,
fingerprints, steps)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import checkpoint as jck
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.observability import integrity

from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.observability import chaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=32)


def _cfg(dtype=torch.float32):
    return ttf.TransformerConfig(dtype=dtype, **CFG)


def _tokens(batch=2, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CFG["vocab_size"], (batch, CFG["max_len"]))


def _assert_same(a, b):
    """Two TransformerLMs (or momentum dicts) hold the same bytes."""
    da = dict(a.named_parameters()) if hasattr(a, "named_parameters") else a
    db = dict(b.named_parameters()) if hasattr(b, "named_parameters") else b
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape
        assert torch.equal(da[k].detach().cpu(), db[k].detach().cpu()), k


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    yield
    chaos.reset()
    ck.wait_for_pending_save()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_exact(tmp_path, dtype):
    cfg = _cfg(dtype)
    p = ttf.init_params(cfg, seed=0, device="cpu")
    m = ttf.init_momentum(p)
    m["embed"].add_(0.25)
    ck.save_checkpoint(str(tmp_path), cfg, p, momentum=m, step=7,
                       metadata={"tag": "x"})
    cfg2, q, m2, step, meta = ck.load_checkpoint(str(tmp_path),
                                                 device="cpu")
    assert cfg2 == cfg and step == 7 and meta == {"tag": "x"}
    _assert_same(p, q)
    _assert_same(m, m2)
    man = json.load(open(tmp_path / "manifest.json"))
    assert man["param_fingerprint"] == tsv.params_fingerprint(p)
    assert man["dtypes"]["p.embed"] == ("bfloat16" if dtype == torch.bfloat16
                                        else "float32")
    assert man["dtypes"]["m.embed"] == "float32"


def test_atomic_overwrite_and_keep_n(tmp_path):
    cfg = _cfg()
    d = str(tmp_path)
    for step in range(1, 5):
        ck.save_checkpoint(d, cfg, ttf.init_params(cfg, seed=step,
                                                   device="cpu"),
                           step=step, keep=2)
    assert [s for s, _ in ck.list_checkpoints(d)] == [3, 4]
    data = sorted(f for f in os.listdir(d) if f.startswith("arrays"))
    assert len(data) == 2 and not any(f.endswith(".tmp")
                                      for f in os.listdir(d))
    _, q, _, step, _ = ck.load_checkpoint(d, device="cpu")
    assert step == 4
    _assert_same(q, ttf.init_params(cfg, seed=4, device="cpu"))
    # keep=1 (the default) sweeps back to one checkpoint, never the newest
    ck.save_checkpoint(d, cfg, q, step=5)
    assert [s for s, _ in ck.list_checkpoints(d)] == [5]
    assert len([f for f in os.listdir(d) if f.startswith("arrays")]) == 1


def _data_file(d):
    return os.path.join(d, json.load(open(os.path.join(
        d, "manifest.json")))["arrays_file"])


@pytest.mark.parametrize("damage", ["truncate", "flip", "missing"])
def test_corrupt_data_file_raises_naming_it(tmp_path, damage):
    cfg = _cfg()
    d = str(tmp_path)
    ck.save_checkpoint(d, cfg, ttf.init_params(cfg, seed=0, device="cpu"),
                       step=1)
    path = _data_file(d)
    name = os.path.basename(path)
    if damage == "missing":
        os.remove(path)
        match = "missing"
    elif damage == "truncate":
        data = open(path, "rb").read()
        open(path, "wb").write(data[:len(data) // 2])
        match = "unreadable"
    else:
        # one byte of the embed array rots, in a well-formed file of the
        # same size: only the per-array digest can catch it
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        raw = bytearray(arrays["p.embed"].tobytes())
        raw[5] ^= 0x10
        arrays["p.embed"] = np.frombuffer(bytes(raw), np.float32).reshape(
            arrays["p.embed"].shape)
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        match = "digest"
    with pytest.raises(ck.CheckpointCorrupt, match=match) as err:
        ck.load_checkpoint(d, device="cpu")
    assert name in str(err.value)
    if damage == "flip":
        assert "manifest says" in str(err.value)
    with pytest.raises(jck.CheckpointCorrupt):
        jck.load_checkpoint(d)
    assert ck.verify_lineage(d, deep=True)[0]["status"] == "corrupt"


def test_fallback_to_retained(tmp_path):
    cfg = _cfg()
    d = str(tmp_path)
    p1 = ttf.init_params(cfg, seed=1, device="cpu")
    ck.save_checkpoint(d, cfg, p1, step=1, keep=2)
    ck.save_checkpoint(d, cfg, ttf.init_params(cfg, seed=2, device="cpu"),
                       step=2, keep=2)
    os.remove(_data_file(d))
    with pytest.warns(RuntimeWarning, match="falling back"):
        _, q, _, step, _ = ck.load_checkpoint(d, device="cpu")
    assert step == 1
    _assert_same(q, p1)
    with pytest.raises(ck.CheckpointCorrupt):
        ck.load_checkpoint(d, fallback=False, device="cpu")


def test_async_save_then_step_at_once_keeps_the_snapshot(tmp_path):
    """The port's train step writes params and momentum in place: a step
    called straight after ``save_checkpoint(..., async_save=True)`` must
    not reach the checkpoint, which holds the values given to the save.
    The next save is the barrier."""
    cfg = _cfg()
    d = str(tmp_path)
    p = ttf.init_params(cfg, seed=0, device="cpu")
    m = ttf.init_momentum(p)
    step_fn = ttf.make_train_step(cfg, lr=0.1)
    step_fn(p, m, _tokens())
    snap_p = {k: v.clone() for k, v in p.named_parameters()}
    snap_m = {k: v.clone() for k, v in m.items()}
    ck.save_checkpoint(d, cfg, p, momentum=m, step=1, async_save=True)
    step_fn(p, m, _tokens(seed=4))          # in place, at once
    assert not torch.equal(p.embed, snap_p["embed"])
    ck.wait_for_pending_save()
    _, q, qm, step, _ = ck.load_checkpoint(d, device="cpu")
    assert step == 1
    _assert_same(q, snap_p)
    _assert_same(qm, snap_m)
    ck.save_checkpoint(d, cfg, p, step=2, async_save=True, keep=2)
    ck.save_checkpoint(d, cfg, p, step=3, keep=2)     # joins the pending
    assert [s for s, _ in ck.list_checkpoints(d)] == [2, 3]


def test_async_failure_reraises_at_the_barrier(tmp_path):
    cfg = _cfg()
    p = ttf.init_params(cfg, seed=0, device="cpu")
    ck.save_checkpoint(str(tmp_path), cfg, p, step=1, async_save=True,
                       metadata={"bad": object()})
    with pytest.raises(TypeError):
        ck.wait_for_pending_save()
    ck.wait_for_pending_save()              # raised once, then clear


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code] + list(args),
                          env=env, capture_output=True, text=True,
                          timeout=300)


_KILL9 = r"""
import sys
from mxnet_tpu_torch.models import transformer as T, checkpoint as C
from mxnet_tpu_torch.observability import chaos
cfg = T.TransformerConfig(vocab_size=41, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, max_len=32)
C.save_checkpoint(sys.argv[1], cfg, T.init_params(cfg, seed=1,
                  device="cpu"), step=1, keep=2)
print("FIRST-SAVE-OK", flush=True)
chaos.install("checkpoint.write:crash:code=19")
C.save_checkpoint(sys.argv[1], cfg, T.init_params(cfg, seed=2,
                  device="cpu"), step=2, keep=2)
print("UNREACHABLE", flush=True)
"""


def test_kill9_mid_save_leaves_previous_loadable(tmp_path):
    d = str(tmp_path / "ck")
    r = _run(_KILL9, d)
    assert "FIRST-SAVE-OK" in r.stdout, r.stderr[-2000:]
    assert "UNREACHABLE" not in r.stdout and r.returncode == 19
    assert "jax" not in r.stderr
    cfg = _cfg()
    _, q, _, step, _ = ck.load_checkpoint(d, device="cpu")
    assert step == 1
    _assert_same(q, ttf.init_params(cfg, seed=1, device="cpu"))
    ck.save_checkpoint(d, cfg, q, step=3)    # sweeps the torn data file
    assert len([f for f in os.listdir(d) if f.startswith("arrays")]) == 1


_SIGTERM = r"""
import os, signal, sys
import numpy as np
from mxnet_tpu_torch.models import transformer as T, checkpoint as C
cfg = T.TransformerConfig(vocab_size=41, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, max_len=32)
params = T.init_params(cfg, seed=0, device="cpu")
mom = T.init_momentum(params)
state = {"step": 0}
C.install_emergency_checkpoint(
    sys.argv[1], lambda: {"cfg": cfg, "params": params, "momentum": mom,
                          "step": state["step"]})
step = T.make_train_step(cfg, lr=0.1)
for i in range(1, 4):
    step(params, mom, np.zeros((2, 32), np.int64))
    state["step"] = i
print("PRE-SIGTERM step=%d" % state["step"], flush=True)
os.kill(os.getpid(), signal.SIGTERM)
print("UNREACHABLE", flush=True)
"""


def test_sigterm_writes_the_emergency_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    r = _run(_SIGTERM, d)
    assert "PRE-SIGTERM step=3" in r.stdout, r.stderr[-2000:]
    assert "UNREACHABLE" not in r.stdout and r.returncode == 143
    assert "emergency checkpoint committed" in r.stdout
    _, p, m, step = ck.restore_train_state(d, device="cpu")
    assert step == 3 and m is not None
    assert ck.load_checkpoint(d, device="cpu")[4]["emergency"] == "sigterm"
    # the uninterrupted three steps give the same bytes
    cfg = _cfg()
    q = ttf.init_params(cfg, seed=0, device="cpu")
    qm = ttf.init_momentum(q)
    fn = ttf.make_train_step(cfg, lr=0.1)
    for _ in range(3):
        fn(q, qm, np.zeros((2, 32), np.int64))
    _assert_same(p, q)
    _assert_same(m, qm)


def test_resume_from_latest_equals_uninterrupted(tmp_path):
    cfg = _cfg()
    d = str(tmp_path)
    calls = []

    def fresh():
        calls.append(1)
        p = ttf.init_params(cfg, seed=0, device="cpu")
        return cfg, p, ttf.init_momentum(p), 0

    fn = ttf.make_train_step(cfg, lr=0.1)
    c, p, m, s = ck.resume_from_latest(d, init=fresh, device="cpu")
    assert s == 0 and calls == [1]
    for i in range(2):
        fn(p, m, _tokens(seed=i))
    ck.save_checkpoint(d, cfg, p, momentum=m, step=2)
    for i in range(2, 4):
        fn(p, m, _tokens(seed=i))            # the uninterrupted run
    c2, q, qm, s2 = ck.resume_from_latest(d, init=fresh, expect_cfg=cfg,
                                          device="cpu")
    assert s2 == 2 and calls == [1] and ck.lineage_head()["step"] == 2
    for i in range(2, 4):
        fn(q, qm, _tokens(seed=i))
    _assert_same(p, q)
    _assert_same(m, qm)
    with pytest.raises(ck.CheckpointIncompatible, match="d_ff"):
        ck.resume_from_latest(d, expect_cfg=ttf.TransformerConfig(
            **dict(CFG, d_ff=64)), device="cpu")
    with pytest.raises(FileNotFoundError):
        ck.resume_from_latest(str(tmp_path / "void"), device="cpu")
    # a checkpoint without momentum resumes with zeros
    ck.save_checkpoint(d, cfg, p, step=9)
    _, _, zm, _ = ck.restore_train_state(d, device="cpu")
    assert all(not v.any() for v in zm.values())


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_loads_in_the_port_bitwise(tmp_path, dtype):
    jcfg = jtf.TransformerConfig(dtype=getattr(jnp, dtype), **CFG)
    jp = jtf.init_params(jcfg, seed=5)
    jm = jax.tree.map(lambda x: x + 0.5, jtf.init_momentum(jp))
    d = str(tmp_path)
    jck.save_checkpoint(d, jcfg, jp, momentum=jm, step=3, keep=2)
    cfg, p, m, step, _ = ck.load_checkpoint(d, device="cpu")
    assert step == 3 and cfg == convert.config_from_jax(jcfg)
    want = convert.params_from_jax(_jax_tree_np(jp), cfg, device="cpu")
    _assert_same(p, want)
    for name, arr in ttf.flatten_tree(_jax_tree_np(jm)).items():
        assert np.array_equal(m[name].numpy(), arr)
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert tsv.params_fingerprint(p) == man["param_fingerprint"] \
        == integrity.params_fingerprint(jp)
    assert ck.verify_lineage(d, deep=True)[0]["status"] == "verified"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_written_loads_in_jax_and_verifies(tmp_path, dtype):
    cfg = _cfg(dtype)
    d = str(tmp_path)
    p = ttf.init_params(cfg, seed=6, device="cpu")
    m = ttf.init_momentum(p)
    ck.save_checkpoint(d, cfg, p, momentum=m, step=1, keep=3)
    ck.save_checkpoint(d, cfg, p, momentum=m, step=2, keep=3)
    jcfg, jp, jm, step, _ = jck.load_checkpoint(d)
    assert step == 2 and jcfg.d_model == 16 and jcfg.num_microbatches == 0
    want = convert.params_to_numpy(p)
    for name, arr in ttf.flatten_tree(_jax_tree_np(jp)).items():
        w = ttf.flatten_tree(want)[name]
        assert np.array_equal(np.asarray(arr, np.float32), w), name
        assert str(arr.dtype) == ("bfloat16" if dtype == torch.bfloat16
                                  else "float32")
    assert integrity.params_fingerprint(jp) == tsv.params_fingerprint(p)
    for lineage in (ck.verify_lineage(d, deep=True),
                    jck.verify_lineage(d, deep=True)):
        assert [e["status"] for e in lineage] == ["verified", "verified"]
        assert lineage[0]["parent"] == "verified"


def test_shard_and_q8_refusals_name_their_items(tmp_path):
    """The shard functions, which refused before they were ported, now
    work: a two-rank set saved by the port lists, merges bitwise and
    resumes, and its layout is JAX's for the same momentum. q8 trees load
    and refuse to train, as in JAX."""
    cfg = _cfg()
    p = ttf.init_params(cfg, seed=0, device="cpu")
    m = {n: torch.full_like(t, 0.5) + i for i, (n, t) in
         enumerate(p.named_parameters())}
    sd = str(tmp_path / "shards")
    for r in range(2):
        ck.save_shard_checkpoint(sd, cfg, p, momentum=m, step=4, rank=r,
                                 world=2, generation=1)
    assert ck.list_shard_generations(sd) == [(1, 4, 2)]
    _, p2, m2, step, extras = ck.load_shard_checkpoint(sd, device="cpu")
    assert step == 4 and extras["world"] == 2
    _assert_same(p2, p)
    _assert_same(m2, m)
    jm = jax.tree.map(np.asarray, ttf.unflatten_tree(
        {n: t.numpy() for n, t in m.items()}))
    assert ck.shard_layout(m, 3) == jck.shard_layout(jm, 3)
    assert ck.resume_elastic(sd, device="cpu")[3] == 4
    jcfg = jtf.TransformerConfig(**CFG)
    q8 = jtf.quantize_weights_int8(jtf.init_params(jcfg, seed=0))
    jck.save_checkpoint(str(tmp_path / "q8"), jcfg, q8, step=1)
    _, got, _, step, _ = ck.load_checkpoint(str(tmp_path / "q8"),
                                            device="cpu")
    assert step == 1 and isinstance(got.layers[0].wq, ttf.Q8Weight)
    np.testing.assert_array_equal(got.layers[0].wq.q8.numpy(),
                                  np.asarray(q8["layers"][0]["wq"]["q8"]))
    assert tsv.params_fingerprint(got) == integrity.params_fingerprint(q8)
    # a training state it is not, as in JAX
    with pytest.raises(ValueError, match="int8-quantized"):
        ck.restore_train_state(str(tmp_path / "q8"), device="cpu")
    with pytest.raises(TypeError, match="TransformerLM"):
        ck.save_checkpoint(str(tmp_path / "x"), _cfg(),
                           jax.tree.map(np.asarray, q8))
