"""Gradient parity of the port's ops of ``ops/reduce_ops.py`` and
``ops/matrix.py`` with the JAX package's (the check and the elementwise
ops are in ``test_torch_op_grads.py``)."""

import pytest

from test_torch_op_grads import check_gradient, differentiable
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", differentiable(("reduce_ops", "matrix")))
def test_op_gradient_parity(name, monkeypatch):
    check_gradient(name, monkeypatch)
