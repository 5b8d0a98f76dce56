"""The port's ``gluon.utils`` against the JAX package's: ``split_data``
(even and uneven, any batch axis, the refusal), ``split_and_load`` onto
one and two contexts, ``clip_global_norm`` (the returned norm, the
scaling, no scaling under the limit, the warning on a non-finite norm),
``check_sha1``, ``download`` (an existing file, a ``file://`` URL, and
the refusal of any other URL: nothing is fetched) and
``shape_is_known``. Tolerance: fp32 at rtol 1e-6."""

import hashlib
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

X = np.random.RandomState(0).uniform(-1, 1, (6, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


@pytest.mark.parametrize("num, axis, even", [(3, 0, True), (4, 0, False),
                                             (2, 1, True), (1, 0, True)])
def test_split_data_matches_jax(num, axis, even):
    got = mt.gluon.utils.split_data(mt.nd.array(X), num, axis, even)
    want = jmx.gluon.utils.split_data(jmx.nd.array(X), num, axis, even)
    assert len(got) == len(want) == num
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_split_refusals_and_split_and_load():
    for mx in (jmx, mt):
        with pytest.raises(ValueError, match="evenly"):
            mx.gluon.utils.split_data(mx.nd.array(X), 4)
    one = mt.gluon.split_and_load(X, [mt.cpu()])
    assert len(one) == 1 and one[0].context == mt.cpu()
    np.testing.assert_array_equal(one[0].asnumpy(), X)
    two = mt.gluon.split_and_load(mt.nd.array(X), [mt.cpu(0), mt.cpu(1)])
    assert [a.context for a in two] == [mt.cpu(0), mt.cpu(1)]
    np.testing.assert_array_equal(np.concatenate([a.asnumpy() for a in two]),
                                  X)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    parts = [X, X[:2] * 3, np.ones(3, np.float32)]
    tarrs = [mt.nd.array(a) for a in parts]
    jarrs = [jmx.nd.array(a) for a in parts]
    tn = mt.gluon.utils.clip_global_norm(tarrs, max_norm)
    jn = jmx.gluon.utils.clip_global_norm(jarrs, max_norm)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for t, j in zip(tarrs, jarrs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    total = np.sqrt(sum((a.asnumpy().astype(np.float64) ** 2).sum()
                        for a in tarrs))
    # clipped to max_norm when over it, else left as it was
    np.testing.assert_allclose(total, min(tn, max_norm), rtol=1e-5)


def test_clip_global_norm_warns_on_a_non_finite_norm():
    arrs = [mt.nd.array(np.array([np.inf, 1.0], np.float32))]
    with pytest.warns(UserWarning, match="nan or inf"):
        mt.gluon.utils.clip_global_norm(arrs, 1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mt.gluon.utils.clip_global_norm(arrs, 1.0, check_isfinite=False)


def test_check_sha1_and_download_fetch_nothing(tmp_path):
    src = tmp_path / "weights.bin"
    src.write_bytes(b"0123456789" * 1000)
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert mt.gluon.utils.check_sha1(str(src), sha)
    assert not mt.gluon.utils.check_sha1(str(src), "0" * 40)
    # an existing file is returned as it is
    assert mt.gluon.utils.download("http://example.invalid/weights.bin",
                                   path=str(src), sha1_hash=sha) == str(src)
    # a file:// URL is copied, into a directory or to a path
    out = tmp_path / "out"
    out.mkdir()
    got = mt.gluon.utils.download("file://" + str(src), path=str(out))
    assert got == str(out / "weights.bin")
    assert mt.gluon.utils.check_sha1(got, sha)
    # any other URL raises, in both packages, and fetches nothing
    for mx in (jmx, mt):
        with pytest.raises(mx.MXNetError, match="weights2.bin"):
            mx.gluon.utils.download("https://example.invalid/weights2.bin",
                                    path=str(out))
    assert sorted(p.name for p in out.iterdir()) == ["weights.bin"]


@pytest.mark.parametrize("shape", [None, (2, 3), (2, 0), (-1, 4), ()])
def test_shape_is_known_matches_jax(shape):
    assert mt.gluon.utils.shape_is_known(shape) == \
        jmx.gluon.utils.shape_is_known(shape)
