"""The port's transformer training path held against the JAX package, on
the CPU, at a small size (vocab 97, d_model 32, 4 heads over 2 KV heads,
2 layers, d_ff 64, 16 tokens, fp32).

Weights come from the JAX package's ``init_params`` and cross by
``convert.py``; tokens are numpy arrays handed to both. JAX runs both of
its attention routes: the dense softmax (its default below
MXNET_FLASH_MIN_SEQ) and its Pallas flash kernels in interpret mode
(MXNET_FLASH_MIN_SEQ=0); the port runs the matching route, which on CPU
tensors is the flash kernels' plain version.

Tolerances (fp32, the same products summed in another order): logits and
loss at atol 1e-4, as the serving tests hold logits; gradients, params
and momentum at rtol 1e-4 / atol 1e-6. RoPE's frequencies come from
torch's and XLA's own ``pow``, which differ by 1-2 ulps; at positions
below 16 that moves an angle by under 1e-6, well inside these bounds.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=16)
# learned positions, and rope with an MoE FFN; both use GQA (CFG)
VARIANTS = {"learned": {}, "rope_moe": {"rope": True, "n_experts": 3}}
ATOL = 1e-4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _setup(monkeypatch, variant, route, seed=0):
    """(jax cfg, jax params, port cfg, port params, tokens [2, 16])."""
    kw = dict(CFG, use_flash_kernel=route == "flash", **VARIANTS[variant])
    if route == "flash":
        monkeypatch.setenv("MXNET_FLASH_MIN_SEQ", "0")
    jcfg, tcfg = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    jp = jtf.init_params(jcfg, seed=seed)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.RandomState(seed).randint(0, 97, (2, 16)).astype(np.int32)
    return jcfg, jp, tcfg, tp, toks


def _grad_tree(tp, loss):
    """The port's gradients, as a JAX-shaped tree of numpy arrays."""
    names, ps = zip(*tp.named_parameters())
    for p in ps:
        p.requires_grad_(True)
    grads = torch.autograd.grad(loss(), ps)
    for p in ps:
        p.requires_grad_(False)
    return ttf.unflatten_tree({n: g.numpy() for n, g in zip(names, grads)})


def _assert_trees_close(got, want, what, **tol):
    want = jax.tree.map(np.asarray, want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    flat_got = ttf.flatten_tree(got)
    for name, w in ttf.flatten_tree(want).items():
        np.testing.assert_allclose(flat_got[name], w, err_msg=what + name,
                                   **tol)


@pytest.mark.parametrize("variant, route", [("learned", "dense"),
                                            ("rope_moe", "flash")])
def test_forward_matches_jax(monkeypatch, variant, route):
    """Logits against JAX's forward. Each variant and each route appears
    here once; the other two pairings are held through their loss and
    every gradient by the two tests below."""
    jcfg, jp, tcfg, tp, toks = _setup(monkeypatch, variant, route)
    want = jax.jit(lambda p, t: jtf.forward(p, t, jcfg))(jp,
                                                         jnp.asarray(toks))
    got = ttf.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 16, 97)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_loss_and_grads_match_jax(monkeypatch):
    """loss_fn and every parameter's gradient against
    jax.value_and_grad (jitted: one compile instead of one per op), for
    rope, GQA and MoE on the dense route. (The train-step test below
    holds the flash route's gradients.)"""
    jcfg, jp, tcfg, tp, toks = _setup(monkeypatch, "rope_moe", "dense",
                                      seed=1)
    jloss, jgrads = jax.jit(lambda p, t: jax.value_and_grad(jtf.loss_fn)(
        p, t, jcfg))(jp, jnp.asarray(toks))
    loss = ttf.loss_fn(tp, toks, tcfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=ATOL)
    grads = _grad_tree(tp, lambda: ttf.loss_fn(tp, toks, tcfg))
    _assert_trees_close(grads, jgrads, "grad ", **GRAD_TOL)


def test_two_train_steps_match_jax(monkeypatch):
    """Params and momentum after each of two make_train_step steps
    (learned positions, GQA, the flash route), from zero momentum. After
    the first step the momentum is the gradient itself, so this also
    holds every gradient of the flash route, where the port
    differentiates through _FlashAttention, against the JAX step's
    jax.value_and_grad through its flash_attention's custom vjp over the
    Pallas kernels."""
    jcfg, jp, tcfg, tp, toks = _setup(monkeypatch, "learned", "flash",
                                      seed=2)
    jstep = jtf.make_train_step(jcfg, lr=0.1)
    jmom = jtf.init_momentum(jp)
    mom = convert.momentum_from_jax(jax.tree.map(np.asarray, jmom), tp)
    step = ttf.make_train_step(tcfg, lr=0.1)
    for i, t in enumerate((toks, np.roll(toks, 3, axis=1))):
        jp, jmom, jloss = jstep(jp, jmom, jnp.asarray(t))
        tp, mom, loss = step(tp, mom, t)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=ATOL)
        what = "step %d " % (i + 1)
        _assert_trees_close(convert.params_to_numpy(tp), jp, what + "param ",
                            **GRAD_TOL)
        _assert_trees_close(convert.momentum_to_numpy(mom), jmom,
                            what + "momentum ", **GRAD_TOL)
    assert not any(p.requires_grad for p in tp.parameters())


def test_guarded_step_skips_non_finite_loss(monkeypatch):
    """make_train_step(guard=True): a finite step equals the unguarded
    one exactly; a non-finite loss leaves params and momentum untouched
    (mirrors tests/test_chaos.py's device-side guard)."""
    _, _, tcfg, tp, toks = _setup(monkeypatch, "learned", "flash", seed=3)
    state = convert.params_to_numpy(tp)

    def fresh():
        return convert.params_from_jax(state, tcfg, "cpu")

    plain = ttf.make_train_step(tcfg, lr=0.1)
    guarded = ttf.make_train_step(tcfg, lr=0.1, guard=True)
    p1, m1, l1 = plain(fresh(), ttf.init_momentum(tp), toks)
    p2, m2, l2, skipped = guarded(fresh(), ttf.init_momentum(tp), toks)
    assert skipped.dtype == torch.bool and not bool(skipped)
    assert torch.equal(l1, l2)
    for a, b in zip(p1.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for name in m1:
        assert torch.equal(m1[name], m2[name])

    bad = fresh()
    with torch.no_grad():
        bad.embed[0, 0] = float("nan")
    before = [p.clone() for p in bad.parameters()]
    p3, m3, l3, skipped = guarded(bad, ttf.init_momentum(tp), toks)
    assert bool(skipped) and not torch.isfinite(l3)
    for a, b in zip(p3.parameters(), before):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert all(not m.any() for m in m3.values())


def test_remat_layers_gives_the_same_gradients(monkeypatch):
    """cfg.remat_layers (torch.utils.checkpoint, non-reentrant): the same
    loss and gradients as storing the activations (mirrors
    tests/test_mirror.py, at its tolerance)."""
    _, _, tcfg, tp, toks = _setup(monkeypatch, "rope_moe", "flash", seed=4)
    rcfg = ttf.TransformerConfig(**dict(vars(tcfg), remat_layers=True))
    base = _grad_tree(tp, lambda: ttf.loss_fn(tp, toks, tcfg))
    remat = _grad_tree(tp, lambda: ttf.loss_fn(tp, toks, rcfg))
    _assert_trees_close(remat, base, "remat grad ", rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_and_momentum_trees_match_jax(variant):
    """One seed gives the JAX package's draws for rope trees (no pos
    table) and MoE layers (gate, then w1, then w2), and both trees round
    trip through convert.py."""
    kw = dict(CFG, **VARIANTS[variant])
    jp = jtf.init_params(jtf.TransformerConfig(**kw), seed=5)
    tcfg = ttf.TransformerConfig(**kw)
    tp = ttf.init_params(tcfg, seed=5, device="cpu")
    _assert_trees_close(convert.params_to_numpy(tp), jp, "init ", rtol=0,
                        atol=0)
    assert ("pos" in convert.params_to_numpy(tp)) == (variant == "learned")
    jmom = jax.tree.map(np.asarray, jtf.init_momentum(jp))
    mom = convert.momentum_from_jax(jmom, tp)
    assert set(mom) == {n for n, _ in tp.named_parameters()}
    assert all(m.dtype == torch.float32 for m in mom.values())
    _assert_trees_close(convert.momentum_to_numpy(mom), jmom, "momentum ",
                        rtol=0, atol=0)
    with pytest.raises(ValueError, match="momentum keys"):
        convert.momentum_from_jax(dict(jmom, extra=np.zeros(1)), tp)


def test_training_entry_points_raise_for_unported_options():
    """The options the training path refused run: a train step under a
    mesh and a pipelined config (one stage without a pp axis) take the
    no-mesh step's values; what the step still refuses is an int8 weight
    tree, a serving artifact, as JAX's restore refuses it."""
    tcfg = ttf.TransformerConfig(use_ring_attention=False, **CFG)
    mesh = parallel.make_mesh({"dp": 1, "sp": 1}, device="cpu")
    pp = ttf.TransformerConfig(**dict(CFG, pp_axis="pp"))
    toks = np.random.RandomState(4).randint(0, 97, (2, 16))
    runs = []
    for cfg, m in ((tcfg, None), (tcfg, mesh), (pp, None)):
        tp = ttf.init_params(cfg, seed=2, device="cpu")
        mom = ttf.init_momentum(tp)
        loss = ttf.make_train_step(cfg, m)(tp, mom, toks)[2]
        runs.append((loss, list(tp.parameters()), list(mom.values())))
    for loss, ps, ms in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(ps, runs[0][1]))
        assert all(torch.equal(a, b) for a, b in zip(ms, runs[0][2]))
    q8 = ttf.quantize_weights_int8(ttf.init_params(tcfg, device="cpu"))
    with pytest.raises(ValueError, match="serving artifact"):
        ttf.make_train_step(tcfg)(q8, {}, toks)


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("route", ["dense", "flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_world_of_one_mesh_step_equals_the_plain_step(variant, route, guard):
    """make_train_step(cfg, mesh) on a world of one, sp without ring
    attention, is make_train_step(cfg) bitwise over 2 steps: every
    collective is the identity and the bucketed all-reduce a pack and an
    unpack."""
    kw = dict(CFG, use_flash_kernel=route == "flash",
              use_ring_attention=False, **VARIANTS[variant])
    cfg = ttf.TransformerConfig(**kw)
    mesh = parallel.make_mesh({"dp": 1, "tp": 1, "sp": 1, "ep": 1},
                              device="cpu")
    toks = np.random.RandomState(5).randint(0, 97, (2, 16))
    runs = []
    for step, shard in ((ttf.make_train_step(cfg, lr=0.1, guard=guard),
                         False),
                        (ttf.make_train_step(cfg, mesh, lr=0.1, guard=guard),
                         True)):
        tp = ttf.init_params(cfg, seed=1, device="cpu")
        if shard:
            tp = ttf.shard_params(tp, cfg, mesh)
        mom = ttf.init_momentum(tp)
        losses = [step(tp, mom, toks)[2] for _ in range(2)]
        runs.append((losses, dict(tp.named_parameters()), mom))
    (la, pa, ma), (lb, pb, mb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(ma[name], mb[name]), name
