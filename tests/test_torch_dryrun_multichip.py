"""``entry.dryrun_multichip(4)``, the port's counterpart of
``__graft_entry__.dryrun_multichip``, in a 4-rank gloo world on the CPU
(each rank a process, joined through a FileStore): the LM train step
under JAX's dp/tp/sp/ep factoring (sp 2 x tp 2, two experts, GQA, RoPE
through the ring, remat), the ResNet-50 dp step through the Gluon
``Trainer`` over ``dist_sync``, and the pp 2 x sp 2 step. Every leg's
loss is finite; the LM and pp legs' losses, the losses of the initial
weights (which the JAX package's ``init_params`` draws alike), lie within
rtol 1e-5 of JAX's ``loss_fn`` of the same configuration, weights and
tokens (fp32; ring attention, the experts and the pipeline sum in
another order). A host whose loopback interface gloo does not pick may
need GLOO_SOCKET_IFNAME=lo."""

import os

import jax.numpy as jnp
import numpy as np

from mxnet_tpu.models import transformer as jtf

from mxnet_tpu_torch import entry
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 1e-5


def test_dryrun_multichip_four_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if "GLOO_SOCKET_IFNAME" not in os.environ:
        monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    losses = entry.dryrun_multichip(4, device="cpu")
    assert sorted(losses) == ["lm", "pp", "resnet50 dp"]
    assert all(np.isfinite(v) for v in losses.values())
    axes = entry._dryrun_axes(4)
    assert axes == {"dp": 1, "tp": 2, "sp": 2, "ep": 1}
    cfg = jtf.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        n_experts=2, max_len=32, n_kv_heads=2, rope=True,
        use_ring_attention=True, remat_layers=True)
    tokens = np.random.RandomState(0).randint(0, 64, (4, 32))
    want = jtf.loss_fn(jtf.init_params(cfg, seed=0),
                       jnp.asarray(tokens, jnp.int32), cfg, None)
    np.testing.assert_allclose(losses["lm"], float(want), rtol=LOSS_RTOL)
    assert entry._dryrun_pp_axes(4) == {"pp": 2, "sp": 2, "tp": 1,
                                        "dp": 1, "ep": 1}
    pp_cfg = jtf.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                   n_layers=4, d_ff=64, max_len=32)
    pp_tokens = np.random.RandomState(1).randint(0, 64, (4, 32))
    want = jtf.loss_fn(jtf.init_params(pp_cfg, seed=0),
                       jnp.asarray(pp_tokens, jnp.int32), pp_cfg, None)
    np.testing.assert_allclose(losses["pp"], float(want), rtol=LOSS_RTOL)
