"""Gluon activation layers (port of ``mxnet_tpu/gluon/nn/activations.py``;
reference: python/mxnet/gluon/nn/activations.py).

``Activation`` and ``Swish``, and the layers over the ``LeakyReLU`` op:
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU`` and ``GELU``.
"""

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    """Applies an activation function: 'relu', 'sigmoid', 'tanh',
    'softrelu', 'softsign' (gluon/nn/activations.py:30)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super(Activation, self).__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "{name}({act})".format(name=self.__class__.__name__,
                                      act=self._act_type)


class LeakyReLU(HybridBlock):
    """Leaky ReLU: f(x) = x if x > 0 else alpha*x."""

    def __init__(self, alpha, **kwargs):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be >= 0."
        super(LeakyReLU, self).__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha, name="fwd")

    def __repr__(self):
        return "{name}({alpha})".format(name=self.__class__.__name__,
                                        alpha=self._alpha)


class PReLU(HybridBlock):
    """Parametric leaky ReLU with learned slope (gluon/nn/activations.py:86)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super(PReLU, self).__init__(**kwargs)
        from ... import initializer
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu", name="fwd")


class ELU(HybridBlock):
    """f(x) = x if x > 0 else alpha*(exp(x)-1)."""

    def __init__(self, alpha=1.0, **kwargs):
        super(ELU, self).__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled exponential linear unit (Klambauer et al. 2017)."""

    def __init__(self, **kwargs):
        super(SELU, self).__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu", name="fwd")


class Swish(HybridBlock):
    """x * sigmoid(beta * x) (Ramachandran et al. 2017)."""

    def __init__(self, beta=1.0, **kwargs):
        super(Swish, self).__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """Gaussian error linear unit: x * Phi(x)
    (gluon/nn/activations.py GELU via LeakyReLU act_type='gelu')."""

    def __init__(self, **kwargs):
        super(GELU, self).__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu", name="fwd")
