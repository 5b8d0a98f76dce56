"""The public names of the JAX package's top level and of its
``ndarray``, in the port: each exists there, or raises ``MXNetError``
naming the ROADMAP item that ports it. The JAX-only internals (``jax``,
``jnp``, ``ensure_backend``, ``num_tpus``, ``tpu``) are the listed
exceptions. The names of ported modules are checked against JAX:
``nd.onehot_encode``, ``nd.maximum_nd``/``minimum_nd`` and the top-level
``Symbol``, ``NameManager``, ``Prefix``, ``optimizer`` and
``lr_scheduler``. Tolerance: exact (the same integer and float values)."""

import importlib
import re

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt

JAX_ONLY = {"jax", "jnp", "ensure_backend", "num_tpus", "tpu"}


def _public(module):
    return sorted(n for n in dir(module)
                  if not n.startswith("_") and n not in JAX_ONLY)


def _exists_or_names_its_item(module, name):
    try:
        getattr(module, name)
    except mt.MXNetError as exc:
        assert re.search(r"ROADMAP item A\d+", str(exc)), (name, str(exc))


@pytest.mark.parametrize("name", _public(jmx))
def test_top_level_name(name):
    _exists_or_names_its_item(mt, name)


@pytest.mark.parametrize("name", _public(jmx.ndarray))
def test_ndarray_name(name):
    _exists_or_names_its_item(mt.ndarray, name)


# the modules of the kvstore stack and the Module front end: every public
# name of the JAX module is present in the port's
STORE_AND_MODULE = ("kvstore", "kvstore_server", "gradient_compression",
                    "metric", "callback", "model", "module",
                    "executor_manager")


@pytest.mark.parametrize("module,name", [
    (m, n) for m in STORE_AND_MODULE
    for n in importlib.import_module("mxnet_tpu." + m).__all__])
def test_kvstore_and_module_name(module, name):
    assert hasattr(importlib.import_module("mxnet_tpu_torch." + module),
                   name), (module, name)


def test_ported_names_exist_and_unported_ones_refuse():
    assert mt.Symbol is mt.symbol.Symbol
    assert mt.NameManager is mt.name.NameManager
    assert mt.Prefix is mt.name.Prefix
    assert mt.optimizer.SGD and mt.lr_scheduler.FactorScheduler
    # the kvstore stack and the Module front end resolve (A7c, A9's first
    # item); the rest of the library still names A9
    assert mt.metric.Accuracy and mt.kvstore.create and mt.module.Module
    assert mt.mod is mt.module and mt.model.FeedForward
    for name in ("sparse", "operator"):
        with pytest.raises(mt.MXNetError, match="A9"):
            getattr(mt, name)
    # random sampling, control flow and the recurrent nets resolve (A9's
    # second item)
    assert mt.rnn.BucketSentenceIter and mt.random.uniform
    assert mt.contrib.ndarray.foreach and mt.contrib.symbol.foreach
    # data and IO resolve (A8 is ported); contrib's other modules name A9
    assert mt.io.ImageRecordIter and mt.recordio.MXIndexedRecordIO
    assert mt.image.ImageIter and mt.contrib.io.DataLoaderIter
    with pytest.raises(mt.MXNetError, match="A9"):
        mt.contrib.amp
    # observability resolves: chaos is ported, the rest names A10
    assert mt.observability.chaos.install
    with pytest.raises(mt.MXNetError, match="A10"):
        mt.observability.hlo
    for name in ("sparse", "csr_matrix", "row_sparse_array"):
        with pytest.raises(mt.MXNetError, match="A9"):
            getattr(mt.nd, name)
    with pytest.raises(AttributeError):
        mt.no_such_name
    with pytest.raises(AttributeError):
        mt.nd.no_such_name


def test_onehot_encode_and_broadcast_max_min_match_jax():
    idx = np.array([1, 0, 3, 2], np.float32)
    a = np.random.RandomState(0).uniform(-1, 1, (3, 1)).astype(np.float32)
    b = np.random.RandomState(1).uniform(-1, 1, (1, 4)).astype(np.float32)
    with mt.cpu():
        got = {}
        for key, mx in (("jax", jmx), ("port", mt)):
            out = mx.nd.zeros((4, 5))
            res = mx.nd.onehot_encode(mx.nd.array(idx), out)
            assert res is out
            got[key] = (out.asnumpy(),
                        mx.nd.maximum_nd(mx.nd.array(a), mx.nd.array(b))
                        .asnumpy(),
                        mx.nd.minimum_nd(mx.nd.array(a), mx.nd.array(b))
                        .asnumpy())
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(t, j)


# the JAX mesh's placement type, which a process-per-rank world has no use
# for: a rank holds its block (parallel.shard) and a spec is parallel.P
PARALLEL_JAX_ONLY = {"NamedSharding"}


@pytest.mark.parametrize("name", sorted(
    set(importlib.import_module("mxnet_tpu.parallel").__all__)
    - PARALLEL_JAX_ONLY))
def test_parallel_name(name):
    """Each public name of the JAX ``parallel`` exists in the port's; the
    elastic module, which raised on import before it was ported, now
    holds every public name of JAX's."""
    if name == "elastic":
        port = importlib.import_module("mxnet_tpu_torch.parallel.elastic")
        jax_names = importlib.import_module(
            "mxnet_tpu.parallel.elastic").__all__
        assert [n for n in jax_names if not hasattr(port, n)] == []
    assert getattr(importlib.import_module("mxnet_tpu_torch.parallel"), name)


@pytest.mark.parametrize("module,name", [
    (m, n) for m in ("parallel.elastic", "models.checkpoint")
    for n in importlib.import_module("mxnet_tpu." + m).__all__])
def test_elastic_and_checkpoint_name(module, name):
    """Each public name of JAX's elastic module and checkpoint module
    exists in the port's, the exit codes with JAX's values."""
    port = importlib.import_module("mxnet_tpu_torch." + module)
    assert hasattr(port, name), name
    if name.endswith("_EXIT_CODE"):
        jmod = importlib.import_module("mxnet_tpu." + module)
        assert getattr(port, name) == getattr(jmod, name)


@pytest.mark.parametrize("name", importlib.import_module(
    "mxnet_tpu.models.transformer").__all__)
def test_transformer_name(name):
    """The JAX transformer module's whole surface exists in the port's:
    nothing of it is refused any more."""
    assert callable(getattr(importlib.import_module(
        "mxnet_tpu_torch.models.transformer"), name))
