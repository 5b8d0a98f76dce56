"""The port's fault injection (``mxnet_tpu_torch/observability/chaos.py``)
held against the JAX package's: the same spec strings parse to the same
rules, the same sequence of ``fire`` calls fires on the same occurrences
in both packages, every fault acts as there, and the injected ``oom``,
like a real ``torch.cuda.OutOfMemoryError``, is recognised by the port's
``membudget.is_resource_exhausted`` (and the injected one by JAX's). The
value faults act on tensors. Tolerance: exact (rule fields, fired
occurrences, flipped bits)."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.observability import chaos as jchaos
from mxnet_tpu.observability import membudget as jmem

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.observability import chaos
from mxnet_tpu_torch.observability import membudget
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    "kvstore.*:delay:ms=250:at=3;io.read:error:count=2;"
    "trainer.grads:nan:every=4:count=0",
    "journal.append:crash:at=8:code=9",
    "serving.dispatch.r1:error:every=1:at=2;"
    "serving.dispatch.r1:error:every=1:count=0",
    "serving.dispatch:oom:at=5:bytes=4096",
    "checkpoint.bytes:bitflip:bit=3:elem=17;router.rollout:error:at=1",
    "s:hang:ms=5:rank=0;t:sigterm:count=0;u:delay",
]
FIELDS = ("pattern", "fault", "at", "every", "count", "ms", "rank", "code",
          "bit", "elem", "bytes")


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_gives_jaxs_rules(spec):
    got = [[getattr(r, f) for f in FIELDS] for r in chaos.parse_spec(spec)]
    want = [[getattr(r, f) for f in FIELDS] for r in jchaos.parse_spec(spec)]
    assert got == want


@pytest.mark.parametrize("bad, match", [
    ("site:explode", "unknown chaos fault"), ("site:delay:ms", "key=value"),
    ("site:delay:volume=11", "unknown key"), ("lonely", "at least")])
def test_bad_specs_raise_as_in_jax(bad, match):
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError, match=match):
            mod.parse_spec(bad)


def test_same_fire_sequence_fires_on_same_occurrences():
    """Six rules over three sites, thirty fires in a fixed interleaving:
    both packages fire the same faults at the same calls, and count the
    same ``seen``/``fired`` per rule and the same ``stats``."""
    spec = ("a:nan:at=2;a:nan:every=3:count=0;b.*:bitflip:every=2:count=3;"
            "b.x:nan:at=0;c:nan:count=0;a:bitflip:at=7:bit=2")
    sites = ["a", "b.x", "c", "b.y", "a", "a"] * 5
    seqs = []
    for mod in (chaos, jchaos):
        rules = mod.install(spec)
        seqs.append(([mod.fire(s, step=k) for k, s in enumerate(sites)],
                     [(r.seen, r.fired) for r in rules],
                     {k: v for k, v in mod.stats.items()
                      if k != "skipped_steps"}))
        mod.reset()
    assert seqs[0] == seqs[1]
    assert any(seqs[0][0])


def test_off_by_default_and_reset():
    assert not chaos.enabled() and chaos.fire("x") == ()
    chaos.inject("x", "nan")
    assert chaos.enabled() and chaos.fire("x") == ("nan",)
    assert chaos.stats["fired"] == 1
    chaos.reset()
    assert not chaos.enabled() and chaos.stats["fired"] == 0


def test_no_environment_is_read(monkeypatch):
    """The port reads no ``MXNET_CHAOS``: rules come only from
    install/inject (JAX's would fire here)."""
    monkeypatch.setenv("MXNET_CHAOS", "boom:error")
    assert not chaos.enabled() and chaos.fire("boom") == ()
    with pytest.raises(jchaos.ChaosError):
        jchaos.fire("boom")


def test_error_delay_hang_and_rank():
    chaos.inject("e", "error")
    with pytest.raises(chaos.ChaosError) as err:
        chaos.fire("e")
    assert isinstance(err.value, OSError)
    assert "occurrence 0" in str(err.value)
    chaos.inject("d", "delay", ms=30)
    t0 = time.perf_counter()
    chaos.fire("d")
    assert time.perf_counter() - t0 >= 0.025
    chaos.inject("h", "hang", ms=5000)
    threading.Timer(0.05, chaos.release).start()
    t0 = time.perf_counter()
    chaos.fire("h")
    assert time.perf_counter() - t0 < 4.0
    # no process group: rank 0
    chaos.inject("r", "nan", rank=1, count=0)
    chaos.inject("r", "nan", rank=0, count=0)
    assert chaos.fire("r") == ("nan",)


def test_oom_is_resource_exhausted_in_both_packages():
    msgs = []
    for mod in (chaos, jchaos):
        mod.inject("serving.dispatch", "oom", at=1, bytes=4096)
        mod.fire("serving.dispatch")
        with pytest.raises(mod.ChaosResourceExhausted) as err:
            mod.fire("serving.dispatch")
        msgs.append(str(err.value))
        for judge in (membudget, jmem):
            assert judge.is_resource_exhausted(err.value)
        mod.reset()
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("RESOURCE_EXHAUSTED: Out of memory while "
                              "trying to allocate 4096 bytes")


def test_cuda_oom_error_is_resource_exhausted():
    exc = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert membudget.is_resource_exhausted(exc)
    assert jmem.is_resource_exhausted(exc)
    assert not membudget.is_resource_exhausted(RuntimeError("boom"))
    assert not membudget.is_resource_exhausted(None)


def test_other_membudget_names_refuse_naming_a10():
    with pytest.raises(mt.MXNetError, match="A10"):
        membudget.preflight_bytes
    assert mt.observability.chaos is chaos
    with pytest.raises(mt.MXNetError, match="A10"):
        mt.observability.hlo


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.int32])
def test_bitflip_array_flips_one_bit_as_jax(dtype):
    """The same rule flips the same bit of the same element as JAX's
    (compared on the integer words)."""
    import jax.numpy as jnp
    base = np.arange(1, 13, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(base).to(dtype)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int8: jnp.int8, torch.int32: jnp.int32}[dtype]
    j = jnp.asarray(base).astype(jdt)
    bits = 8 * t.element_size()
    word = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.uint16),
            4: (torch.int32, np.uint32)}[t.element_size()]
    for bit, elem in ((0, 0), (bits - 1, 5), (3, 29)):
        spec = "v:bitflip:bit=%d:elem=%d" % (bit, elem)
        chaos.install(spec)
        jchaos.install(spec)
        got = chaos.bitflip_array("v", t)
        want = jchaos.bitflip_array("v", j)
        chaos.reset()
        jchaos.reset()
        assert got.dtype == t.dtype and got.shape == t.shape
        assert np.array_equal(got.view(word[0]).numpy().astype(word[1]),
                              np.asarray(want).view(word[1]))
        assert int((got.view(word[0]) != t.view(word[0])).sum()) == 1


def test_corrupt_bytes_and_file_flip_the_same_bit(tmp_path):
    data = bytes(range(40))
    out = []
    for mod in (chaos, jchaos):
        mod.install("f:bitflip:bit=5:elem=43")
        out.append(mod.corrupt_bytes("f", data))
        mod.reset()
        path = tmp_path / ("f%d" % len(out))
        path.write_bytes(data)
        mod.install("f:bitflip:bit=1:elem=7")
        assert mod.corrupt_file("f", str(path))
        mod.reset()
        out.append(path.read_bytes())
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0] != data and out[1] != data


def test_poison_ndarrays_and_step_guard():
    with mt.cpu():
        a = mt.nd.array(np.ones((2, 3), np.float32))
        b = mt.nd.array(np.ones((2,), np.int32), dtype="int32")
        chaos.inject("trainer.grads", "nan", at=1)
        assert not chaos.poison_ndarrays("trainer.grads", [a, b])
        assert chaos.poison_ndarrays("trainer.grads", [a, b])
        assert torch.isnan(a._data).all() and not b._data.is_floating_point()
        assert not chaos.all_finite([a._data, b._data])
        assert chaos.all_finite([b._data, None])
        chaos.reset()
        c = mt.nd.array(np.zeros((4,), np.float32))
        # element 7 of the concatenation [a (6), c (4)] is c[1]
        chaos.inject("p", "bitflip", bit=31, elem=7)
        assert chaos.poison_bitflip("p", [a, c])
        assert torch.signbit(c._data[1]) and float(c._data[1]) == 0.0
        assert not torch.signbit(c._data[[0, 2, 3]]).any()
    assert not chaos.step_guard_enabled()
    chaos.set_step_guard(True)
    try:
        assert chaos.step_guard_enabled()
    finally:
        chaos.set_step_guard(False)
    chaos.count_skipped_step("trainer")
    assert chaos.stats["skipped_steps"] == 1


_CRASH = r"""
import sys
from mxnet_tpu_torch.observability import chaos
chaos.install(sys.argv[1])
for k in range(5):
    chaos.fire("site", k=k)
print("survived", flush=True)
"""


@pytest.mark.parametrize("spec, code", [("site:crash:at=3:code=9", 9),
                                        ("site:sigterm:at=2", -15)])
def test_crash_and_sigterm_in_a_subprocess(spec, code):
    """``crash`` exits at once with its code (no cleanup); ``sigterm``
    signals the process itself. The child imports torch and the port
    only."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _CRASH, spec], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    assert signal.SIGTERM == 15
