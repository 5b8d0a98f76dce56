"""The port's ring-attention step, mesh layer and transformer under a
world-of-one mesh, held against the JAX package on the CPU, at a small
size (carry blocks of 3 x 64 x 16; the transformer of
tests/test_torch_transformer.py). The 4-rank gloo world is in
tests/test_torch_ring_world.py.

The carry's plain version is held against JAX's ``flash_carry_block``
(the Pallas kernel in interpret mode, whose blocks are 64 at these
lengths, as the port's) and against the jnp route of
``local_attention_block`` at rtol = atol = 1e-5 (fp32, the same products
summed in another order). Rows that have seen no unmasked key are
unspecified (see ``flash_carry_block``) and are left out of both
comparisons; one such row is pinned against the interpret kernel, whose
64-key tile is live there as the port's.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.parallel import ring
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("mxnet_tpu.kernels.flash_attention")
jring = importlib.import_module("mxnet_tpu.parallel.ring")
jparallel = importlib.import_module("mxnet_tpu.parallel")
jtf = importlib.import_module("mxnet_tpu.models.transformer")
tfa = importlib.import_module("mxnet_tpu_torch.kernels.flash_attention")

BH, T, D = 3, 64, 16
TOL = dict(rtol=1e-5, atol=1e-5)
# (q_offset, kv_offset): own block, a past shard, a shard past the
# diagonal (dead when causal), offsets not multiples of the tile
OFFSETS = ((0, 0), (64, 0), (0, 64), (96, 64), (32, 0))
CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=16)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(BH, T, D).astype(np.float32) for _ in range(5)]


def _fresh():
    return (np.zeros((BH, T, D), np.float32),
            np.full((BH, T), -1e30, np.float32),
            np.zeros((BH, T), np.float32))


def _jax_carry(q, k, v, carry, q_offset, kv_offset, causal):
    out = jfa.flash_carry_block(*(jnp.asarray(x) for x in (q, k, v) + carry),
                                q_offset, kv_offset, causal)
    return tuple(np.asarray(x) for x in out)


def _port_carry(q, k, v, carry, q_offset, kv_offset, causal):
    out = tfa.flash_carry_block(*(torch.from_numpy(x.copy())
                                  for x in (q, k, v) + carry),
                                q_offset, kv_offset, causal)
    return tuple(x.numpy() for x in out)


def _jnp_route(q, k, v, carry, q_offset, kv_offset, causal):
    """JAX's local_attention_block (jnp route) on the [BH, T, D] layout
    (B = 1, H = BH), carry in and out as (o, m, l) [BH, ...]."""
    def to4(x):
        return jnp.asarray(x.reshape(1, BH, T, -1).transpose(0, 2, 1, 3))

    o, m, l = carry
    jc = (to4(o), jnp.asarray(m[None]), jnp.asarray(l[None]))
    o, m, l = jring.local_attention_block(
        to4(q), to4(k), to4(v), q_offset, kv_offset, causal, 1 / np.sqrt(D),
        carry=jc)
    return (np.asarray(o).transpose(0, 2, 1, 3).reshape(BH, T, D),
            np.asarray(m)[0], np.asarray(l)[0])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offsets", OFFSETS, ids=lambda o: "q%d-kv%d" % o)
@pytest.mark.parametrize("carry", ["fresh", "in_flight"])
def test_carry_plain_matches_jax(causal, offsets, carry):
    q, k, v, k0, v0 = _inputs()
    q_offset, kv_offset = offsets
    c = _fresh()
    if carry == "in_flight":
        # the carry after the q shard's own block, as a ring leaves it
        c = _jax_carry(q, k0, v0, c, q_offset, q_offset, True)
    got = _port_carry(q, k, v, c, q_offset, kv_offset, causal)
    want = _jax_carry(q, k, v, c, q_offset, kv_offset, causal)
    jnp_route = _jnp_route(q, k, v, c, q_offset, kv_offset, causal)
    rows = np.arange(T)
    specified = (c[1] > -1e29) | (q_offset + rows >= kv_offset)[None] \
        | (not causal)
    for name, g, w, r in zip("oml", got, want, jnp_route):
        np.testing.assert_allclose(g[specified], w[specified],
                                   err_msg="vs kernel " + name, **TOL)
        np.testing.assert_allclose(g[specified], r[specified],
                                   err_msg="vs jnp route " + name, **TOL)
    if causal and kv_offset > q_offset + T - 1:
        for g, c_in in zip(got, c):             # a dead call: bitwise
            assert np.array_equal(g, c_in)


def test_carry_unspecified_row_pinned():
    """A fresh carry at q_offset 0, kv_offset 32 (blocks of 64 on both
    sides): row 0 sees only masked keys of a live tile, so each counts
    p = exp(-1e30 + 1e30) = 1: l = 64 and m = -1e30, as the JAX kernel."""
    q, k, v, _, _ = _inputs(1)
    got = _port_carry(q, k, v, _fresh(), 0, 32, True)
    want = _jax_carry(q, k, v, _fresh(), 0, 32, True)
    assert np.all(got[2][:, 0] == 64.0) and np.all(want[2][:, 0] == 64.0)
    assert np.all(got[1][:, 0] == np.float32(-1e30))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_carry_is_forward_only():
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs())
    o, m, l = (torch.from_numpy(x) for x in _fresh())
    with pytest.raises(RuntimeError, match="forward-only"):
        tfa.flash_carry_block(q.requires_grad_(True), k, v, o, m, l, 0, 0,
                              True)
    with torch.no_grad():
        tfa.flash_carry_block(q, k, v, o, m, l, 0, 0, True)


def test_carry_checks_its_carry():
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs())
    o, m, l = (torch.from_numpy(x) for x in _fresh())
    with pytest.raises(ValueError, match="carry"):
        tfa.flash_carry_block(q, k, v, o[:, :8], m, l, 0, 0, True)
    with pytest.raises(ValueError, match="int32"):
        tfa.flash_carry_block(q, k, v, o, m, l, 2 ** 31, 0, True)


# ---------------------------------------------------- world-of-one mesh ---

def _mesh(axes=None):
    return parallel.make_mesh(axes or {"dp": 1, "sp": 1}, device="cpu")


def test_world_of_one_mesh_and_collectives():
    mesh = _mesh({"dp": 1, "tp": 1, "sp": 1, "ep": 1})
    assert parallel.device_count() == 1 and mesh.size == 1
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 1, "ep": 1}
    assert mesh.axis_index("sp") == 0 and mesh.axis_size(("dp", "sp")) == 1
    assert parallel.make_mesh({"dp": -1, "sp": 1}, device="cpu").shape == \
        {"dp": 1, "sp": 1}
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.all_reduce(x, "sp", mesh=mesh) is x
    assert parallel.ring_permute(x, "sp", mesh=mesh) is x
    assert parallel.all_gather(x, "dp", axis=1, mesh=mesh) is x
    assert parallel.all_gather(x, "dp", tiled=False, mesh=mesh).shape == \
        (1, 2, 3)
    assert parallel.reduce_scatter(x, "dp", mesh=mesh) is x
    with parallel.use_mesh(mesh):
        assert parallel.current_mesh() is mesh
        assert parallel.all_reduce(x, ("dp", "sp")) is x
    with pytest.raises(ValueError, match="axis"):
        mesh.axis_index("pp")
    with pytest.raises(ValueError, match="cover"):
        parallel.make_mesh({"sp": 2}, device="cpu")
    assert parallel.init_distributed() is False


@pytest.mark.parametrize("flash", [False, True], ids=["jnp", "carry"])
@pytest.mark.parametrize("rope", [False, True], ids=["learned", "rope"])
def test_world_of_one_forward_and_loss_go_through_the_ring(
        monkeypatch, rope, flash):
    """forward / loss_fn under make_mesh({"dp": 1, "sp": 1}) without a
    process group equal the no-mesh ones, through a ring of one step per
    layer (the plain carry with use_flash_kernel)."""
    cfg = ttf.TransformerConfig(rope=rope, use_flash_kernel=flash, **CFG)
    params = ttf.init_params(cfg, seed=3, device="cpu")
    tokens = np.random.RandomState(4).randint(0, 97, (3, 16))
    want = ttf.forward(params, tokens, cfg)
    want_loss = ttf.loss_fn(params, tokens, cfg)
    calls = []
    fold = ring.local_attention_block
    monkeypatch.setattr(ring, "local_attention_block",
                        lambda *a, **k: calls.append(k) or fold(*a, **k))
    mesh = _mesh()
    params = ttf.shard_params(params, cfg, mesh)
    got = ttf.forward(params, tokens, cfg, mesh)
    got_loss = ttf.loss_fn(params, tokens, cfg, mesh)
    assert len(calls) == 2 * cfg.n_layers
    assert all(c["use_flash_kernel"] == flash for c in calls)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-6


def test_sp_flash_decode_world_of_one_matches_jax():
    """Both per-shard routes at sp = 1 against JAX's on a one-device sp
    mesh, GQA, with a zero-length row."""
    rng = np.random.RandomState(5)
    q = rng.randn(3, 4, D).astype(np.float32)
    kc, vc = (rng.randn(3, 32, 2, D).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 32, 13], np.int32)
    jmesh = jparallel.make_mesh({"sp": 1}, devices=jax.devices()[:1])
    want = np.asarray(jring.sp_flash_decode(
        *(jnp.asarray(x) for x in (q, kc, vc, lengths)), jmesh))
    for use_pallas in (True, False):
        got = ring.sp_flash_decode(*(torch.from_numpy(x)
                                     for x in (q, kc, vc, lengths)),
                                   _mesh({"sp": 1}), use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_config_crosses_over():
    jcfg = jtf.TransformerConfig(dtype=jnp.bfloat16, sp_axis="seq",
                                 use_ring_attention=False, rope=True, **CFG)
    cfg = convert.config_from_jax(jcfg)
    assert cfg == ttf.TransformerConfig(dtype=torch.bfloat16, sp_axis="seq",
                                        use_ring_attention=False, rope=True,
                                        **CFG)


def test_smoke_ring_schedule_matches_full_attention():
    """chip_smoke.py's one-card ring schedule (every shard's ring in
    ring_attention's order, here through the plain carry) equals full
    causal attention; its work count takes the causal pairs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, 2, D).astype(np.float32))
               for _ in range(3))
    want = tfa.dense_attention_with_lse(
        *(x.transpose(1, 2).reshape(4, 64, D) for x in (q, k, v)), True)[0]
    for n in (1, 4):
        got = cs.ring_schedule(torch, ring, q, k, v, n)
        np.testing.assert_allclose(
            got.transpose(1, 2).reshape(4, 64, D).numpy(), want.numpy(),
            **TOL)
    assert cs.carry_work(1, 64, 64, D, 2, 0, 0, True)[1] == \
        2 * 2 * (64 * 65 // 2) * D
    assert cs.carry_work(1, 64, 64, D, 2, 64, 0, True)[1] == \
        cs.carry_work(1, 64, 64, D, 2, 0, 0, False)[1] == 2 * 2 * 64 * 64 * D


# ------------------------------------------------------------ refusals ---

def test_refusals_name_their_slice():
    """What the parallel slice refused now runs at a world of one and
    equals the no-mesh path: the train step under a mesh, the pp config
    (a mesh without a pp axis has one stage) and the bucketed
    all-reduce; a mesh without the config's sp axis still raises. Without
    ring attention the mesh step is the no-mesh step, bitwise."""
    cfg = ttf.TransformerConfig(use_ring_attention=False, **CFG)
    params = ttf.init_params(cfg, device="cpu")
    tokens = np.random.RandomState(3).randint(0, CFG["vocab_size"], (2, 8))
    mom = ttf.init_momentum(params)
    plain = ttf.init_params(cfg, device="cpu")
    plain_mom = ttf.init_momentum(plain)
    loss = ttf.make_train_step(cfg, _mesh())(params, mom, tokens)[2]
    want = ttf.make_train_step(cfg)(plain, plain_mom, tokens)[2]
    assert torch.equal(loss, want)
    for (name, got), ref in zip(params.named_parameters(),
                                plain.parameters()):
        assert torch.equal(got, ref), name
    pp = ttf.TransformerConfig(pp_axis="pp", use_ring_attention=False, **CFG)
    assert torch.equal(ttf.forward(params, tokens, pp, _mesh()),
                       ttf.forward(params, tokens, cfg))
    with pytest.raises(ValueError, match="sp_axis"):
        ttf.forward(params, tokens, cfg, _mesh({"dp": 1}))
    xs = [torch.arange(3.0), torch.ones(2, 2, dtype=torch.bfloat16)]
    got = parallel.bucketed_all_reduce(xs, ("dp", "sp"), mesh=_mesh())
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, xs))


@pytest.mark.parametrize("name", ["fusion", "elastic", "pipeline"])
def test_unported_parallel_modules_raise(name):
    """fusion (both halves: the in-step bucketed all-reduce and the
    store's FlatOptimizer, ShardSlot and switches), pipeline and elastic
    (which raised on import before it was ported) are ported, every
    public name of the JAX modules present and the switches answering;
    elastic's exit codes and default knobs are JAX's."""
    mod = importlib.import_module("mxnet_tpu_torch.parallel." + name)
    if name == "elastic":
        jel = importlib.import_module("mxnet_tpu.parallel.elastic")
        assert (mod.SHRINK_EXIT_CODE, mod.BOUNDARY_EXIT_CODE) == \
            (jel.SHRINK_EXIT_CODE, jel.BOUNDARY_EXIT_CODE)
        assert (mod.heartbeat_s(), mod.miss_threshold(),
                mod.keep_global_batch()) == (2.0, 3, False)
        assert mod.accumulation_factor(4, 2) == \
            jel.accumulation_factor(4, 2) == 2
    jmod = importlib.import_module("mxnet_tpu.parallel." + name)
    for attr in jmod.__all__:
        assert hasattr(mod, attr), attr
    if name == "fusion":
        assert mod.fusion_enabled() is True
        assert mod.shard_update_enabled() is False
