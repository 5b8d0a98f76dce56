"""Helpers for the tests that hold the port's Gluon recurrent blocks
against the JAX package's: a block built in both packages under one
explicit prefix with every parameter set to the same seeded values, and
a comparison of what a run of each gives at fp32 atol 1e-5 / rtol 1e-4.
Import ``on_cpu`` into a test module to run its tests under
``with mt.cpu():``."""

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt

ATOL, RTOL = 1e-5, 1e-4
PKGS = (("jax", jmx), ("port", mt))


@pytest.fixture(autouse=True)
def on_cpu():
    with mt.cpu():
        yield


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def pair(make, seed=0, scale=0.5):
    """{pkg: block} for ``make(mx)`` in each package, initialized on the
    CPU, every parameter set to the same draw from ``RandomState(seed)``
    in U(-scale, scale), by name."""
    blocks = {key: make(mx) for key, mx in PKGS}
    for key, mx in PKGS:
        blocks[key].initialize(ctx=mx.cpu())
    jp = blocks["jax"].collect_params()
    tp = blocks["port"].collect_params()
    assert list(tp.keys()) == list(jp.keys())
    rs = np.random.RandomState(seed)
    for name in jp.keys():
        v = rs.uniform(-scale, scale, jp[name].shape).astype(np.float32)
        jp[name].set_data(jmx.nd.array(v))
        tp[name].set_data(mt.nd.array(v))
    return blocks


def inputs(*shapes, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.rand(*s).astype(np.float32) for s in shapes]


def both(blocks, run):
    """{pkg: run(mx, block)} as numpy, held port against JAX."""
    got = {key: flat(run(mx, blocks[key])) for key, mx in PKGS}
    assert len(got["port"]) == len(got["jax"])
    for g, w in zip(got["port"], got["jax"]):
        assert g.shape == w.shape
        close(g, w)
    return got


def flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in flat(v)]
    return [x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)]
