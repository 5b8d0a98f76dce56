"""The port's weight-only int8 trees (``quantize_weights_int8``) held
against the JAX package's on the CPU, at a small size (vocab 97, d_model
32, 4 heads over 2 KV heads, 2 layers, d_ff 64, max_len 64, 8-position
blocks): the codes, the scales and the dequantised tree are JAX's bit
for bit, in float32 and bfloat16, dense and MoE; quantising twice changes
nothing; greedy streams of ``generate``, ``decode_step_paged`` and the
paged batcher on a q8 tree are JAX's on its q8 tree token for token; the
batcher in every mode serves a q8 tree as its dequantised twin, and
``weight_fingerprint`` folds the q8 bytes as JAX does; checkpoints cross
both ways; ``convert`` carries q8 numpy trees; and ``shard_params``
slices each scale with its codes. Tolerances: exact, except decode logits
at atol 1e-4 (fp32, the same products summed in another order)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.observability import integrity

from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")
jsv = importlib.import_module("mxnet_tpu.models.serving")
jck = importlib.import_module("mxnet_tpu.models.checkpoint")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
BS = 8
ATOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _models(dtype="float32", seed=0, **over):
    kw = dict(CFG, **over)
    tdt, jdt = DTYPES[dtype]
    jcfg = jtf.TransformerConfig(dtype=jdt, **kw)
    tcfg = ttf.TransformerConfig(dtype=tdt, **kw)
    jq = jtf.quantize_weights_int8(jtf.init_params(jcfg, seed=seed))
    tq = ttf.quantize_weights_int8(ttf.init_params(tcfg, seed=seed,
                                                   device="cpu"))
    return jcfg, jq, tcfg, tq


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax_flat(tree):
    """{port leaf name: JAX leaf} of a JAX parameter tree."""
    return ttf.flatten_tree(tree)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantiser_and_dequantised_tree_are_jax_bitwise(dtype, moe):
    over = dict(n_experts=3) if moe else {}
    jcfg, jq, tcfg, tq = _models(dtype, seed=4, **over)
    leaves = ttf.named_leaves(tq)
    jflat = _jax_flat(jq)
    assert set(leaves) == set(jflat)
    for name, leaf in leaves.items():
        want = jflat[name]
        if isinstance(leaf, ttf.Q8Weight):
            assert leaf.q8.dtype == torch.int8 and leaf.dt == DTYPES[dtype][0]
            np.testing.assert_array_equal(leaf.q8.numpy(),
                                          np.asarray(want["q8"]), name)
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(want["scale"]), name)
        else:                               # norms stay as they are
            np.testing.assert_array_equal(_bits(leaf), _jbits(want), name)
    got = ttf.named_leaves(ttf._dequantize_weights(tq))
    jdq = _jax_flat(jtf._dequantize_weights(jq))
    for name, t in got.items():
        assert t.dtype == DTYPES[dtype][0]
        np.testing.assert_array_equal(_bits(t), _jbits(jdq[name]), name)
    # idempotent: a second quantisation keeps every bit
    again = ttf.flat_tensors(ttf.quantize_weights_int8(tq))
    for name, t in ttf.flat_tensors(tq).items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_generate_on_q8_matches_jax(monkeypatch, flash):
    if flash:
        monkeypatch.setenv("MXNET_FLASH_MIN_SEQ", "0")
    jcfg, jq, tcfg, tq = _models(seed=6, rope=True, use_flash_kernel=flash)
    prompt = np.random.RandomState(6).randint(0, 97, (3, 7)).astype(np.int32)
    want = jtf.generate(jq, jnp.asarray(prompt), 12, jcfg)
    got = ttf.generate(tq, prompt, 12, tcfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same stream as the dequantised twin: the weights are bitwise
    twin = ttf.generate(ttf._dequantize_weights(tq), prompt, 12, tcfg,
                        device="cpu")
    assert torch.equal(got, twin)


def test_decode_step_paged_on_q8_matches_jax():
    jcfg, jq, tcfg, tq = _models(seed=7)
    rng = np.random.RandomState(7)
    b, nb = 3, CFG["max_len"] // BS
    tables = np.arange(1, 1 + b * nb, dtype=np.int32).reshape(b, nb)
    jpool = jtf.init_paged_cache(jcfg, 1 + b * nb, BS)
    tpool = ttf.init_paged_cache(tcfg, 1 + b * nb, BS, "cpu")
    tok = rng.randint(0, 97, b).astype(np.int32)
    pos = np.array([0, 3, 9], np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for _ in range(10):
        jl, jpool = jtf.decode_step_paged(jq, jpool, jnp.asarray(tables),
                                          jtok, jnp.asarray(pos), jcfg)
        tl, tpool = ttf.decode_step_paged(tq, tpool, torch.from_numpy(tables),
                                          ttok, torch.from_numpy(pos), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = pos + 1


def _jobs(seed, n=5):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, 97, n_tok)], m)
            for n_tok, m in zip([3, 12, 5, 14, 1][:n], [9, 4, 17, 6, 2][:n])]


def test_paged_batcher_on_q8_matches_jax():
    jcfg, jq, tcfg, tq = _models(seed=11)
    jobs = _jobs(12)
    want, want_order = jsv.ContinuousBatcher(
        jq, jcfg, max_batch=3, paged=True, block_size=BS).run(jobs)
    srv = tsv.ContinuousBatcher(tq, tcfg, max_batch=3, paged=True,
                                block_size=BS, device="cpu")
    got, order = srv.run(jobs)
    assert order == want_order and got == want
    srv.check_invariants(quiesce=True)
    assert srv.weight_fingerprint == integrity.params_fingerprint(jq)


# (label, config changes, batcher options): every mode of the batcher
MODES = (("dense", {}, dict(paged=None)),
         ("paged", {}, dict(paged=True, block_size=BS)),
         ("int8_kv", dict(kv_cache_int8=True), dict(paged=True,
                                                    block_size=BS)),
         ("spec", {}, dict(paged=True, block_size=BS, spec_k=2)),
         ("chunked", dict(rope=True), dict(paged=True, block_size=BS,
                                           chunk_size=4,
                                           pipeline_depth=2)))


@pytest.mark.parametrize("label, over, opts", MODES,
                         ids=[m[0] for m in MODES])
def test_batcher_serves_q8_as_its_dequantised_twin(label, over, opts):
    """The batcher in each mode serves a q8 tree token for token as the
    same weights dequantised (bitwise the same values reach the same
    code), and swap_weights between the two keeps the streams."""
    _, _, tcfg, tq = _models(seed=13, **over)
    twin = ttf._dequantize_weights(tq)
    jobs = _jobs(14)
    runs = []
    for params in (tq, twin):
        srv = tsv.ContinuousBatcher(params, tcfg, max_batch=3,
                                    device="cpu", **opts)
        runs.append(srv.run(jobs))
        srv.check_invariants(quiesce=True)
    assert runs[0] == runs[1]
    srv = tsv.ContinuousBatcher(tq, tcfg, max_batch=3, device="cpu", **opts)
    fp = srv.weight_fingerprint
    rids = [srv.admit(*job) for job in jobs[:3]]
    done = dict(srv.step())
    swapped = srv.swap_weights(twin)
    assert swapped["previous"] == fp != swapped["fingerprint"]
    while len(done) < len(rids):
        done.update(srv.step())
    want, order = runs[1]
    assert [done[r] for r in rids] == [want[r] for r in order[:3]]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_q8_checkpoints_cross_both_ways(tmp_path, dtype):
    jcfg, jq, tcfg, tq = _models(dtype, seed=9)
    # a JAX-written q8 checkpoint loads in the port, bitwise
    jck.save_checkpoint(str(tmp_path / "jax"), jcfg, jq, step=3)
    cfg, got, mom, step, _ = ck.load_checkpoint(str(tmp_path / "jax"),
                                                device="cpu")
    assert step == 3 and mom is None and cfg.dtype == tcfg.dtype
    want = ttf.flat_tensors(tq)
    for name, t in ttf.flat_tensors(got).items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name
    assert tsv.params_fingerprint(got) == integrity.params_fingerprint(jq)
    # a port-written one loads in JAX, bitwise, and verifies in both
    ck.save_checkpoint(str(tmp_path / "port"), tcfg, tq, step=4)
    _, jgot, _, jstep, _ = jck.load_checkpoint(str(tmp_path / "port"))
    assert jstep == 4
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jq)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_jbits(a), _jbits(b))
    for lineage in (ck.verify_lineage(str(tmp_path / "port"), deep=True),
                    jck.verify_lineage(str(tmp_path / "port"), deep=True)):
        assert lineage[0]["status"] == "verified"
    # and back: the port's own round trip
    _, back, _, _, _ = ck.load_checkpoint(str(tmp_path / "port"),
                                          device="cpu")
    assert tsv.params_fingerprint(back) == tsv.params_fingerprint(tq)


def test_convert_carries_q8_numpy_trees():
    jcfg, jq, tcfg, tq = _models("bfloat16", seed=2)
    got = convert.params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    want = ttf.flat_tensors(tq)
    for name, t in ttf.flat_tensors(got).items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name
    tree = convert.params_to_numpy(got)
    assert tree["layers"][0]["wq"]["dt"] == "bfloat16"
    back = convert.params_from_jax(tree, tcfg, "cpu")
    assert tsv.params_fingerprint(back) == tsv.params_fingerprint(tq)


class _Coords:
    """A stand-in mesh: the coordinates of one rank, for shard_params'
    slicing (no process group is needed to slice)."""

    def __init__(self, **coords):
        self.shape = {n: s for n, (s, _) in coords.items()}
        self.coords = {n: i for n, (_, i) in coords.items()}
        self.device = torch.device("cpu")

    def axis_size(self, name):
        return self.shape[name]

    def axis_index(self, name):
        return self.coords[name]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_slices_scale_with_payload(moe, rank):
    """Under tp = 2 (and ep = 2 with MoE) each rank's scale is sliced on
    every dimension past the first that its codes are: q/k/v's [1, H, hd]
    over heads, dense w1's [1, d_ff] over columns, MoE w1's [1, D, d_ff]
    on its last axis and w2's [1, d_ff, D] on its middle one; wo's and
    dense w2's scales (split only on the leading axis, which a scale does
    not have) stay whole. Every rank's
    dequantised block is the block of the dequantised whole, bitwise."""
    over = dict(n_experts=4) if moe else {}
    _, _, tcfg, tq = _models(seed=5, **over)
    mesh = _Coords(dp=(1, 0), sp=(1, 0), tp=(2, rank), ep=(2, rank))
    local = ttf.shard_params(tq, tcfg, mesh)
    layer, whole = local.layers[0], tq.layers[0]
    hd = CFG["d_model"] // CFG["n_heads"]
    assert layer.wq.q8.shape == (32, 2, hd) and layer.wq.scale.shape == \
        (1, 2, hd)
    assert layer.wk.scale.shape == (1, 1, hd)
    assert layer.wo.scale.shape == whole.wo.scale.shape == (1, hd, 32)
    if moe:
        assert layer.w1.q8.shape == (2, 32, 32)
        assert layer.w1.scale.shape == (1, 32, 32)
        assert layer.w2.scale.shape == (1, 32, 32)      # [1, d_ff, D] on tp
    else:
        assert layer.w1.scale.shape == (1, 32)
        assert layer.w2.scale.shape == whole.w2.scale.shape == (1, 32)
    specs = ttf.flatten_tree(ttf.param_specs(tcfg))
    full = ttf.named_leaves(ttf._dequantize_weights(tq))
    for name, leaf in ttf.named_leaves(local).items():
        want = full[name]
        for dim, axis in enumerate(specs[name]):
            if axis is not None:
                block = want.shape[dim] // 2
                want = want.narrow(dim, rank * block, block)
        assert torch.equal(ttf._w(leaf), want), name
