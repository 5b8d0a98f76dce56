"""Gluon convolutional and pooling layers (port of
``mxnet_tpu/gluon/nn/conv_layers.py``; reference:
python/mxnet/gluon/nn/conv_layers.py:47-1202).

Convolutions, transposed convolutions and pooling run the
``Convolution``, ``Deconvolution`` and ``Pooling`` ops of ``ops/nn.py``
in MXNet's NC[DHW] layout.
"""

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _sized(value, ndim, label="kernel_size"):
    """Broadcast an int to an ndim-tuple and validate the arity."""
    out = _to_tuple(value, ndim)
    assert len(out) == ndim, \
        "%s must be a number or %d-tuple" % (label, ndim)
    return out


class _Conv(HybridBlock):
    """Base convolution (gluon/nn/conv_layers.py:47)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super(_Conv, self).__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            ndim = len(kernel_size)
            strides = _to_tuple(strides, ndim)
            padding = _to_tuple(padding, ndim)
            dilation = _to_tuple(dilation, ndim)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            if op_name == "Convolution":
                wshape = (channels, in_channels // groups) + \
                    tuple(kernel_size) if in_channels else \
                    (channels, 0) + tuple(kernel_size)
            else:  # Deconvolution: weight is (in, out//groups, *k)
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size) if in_channels else \
                    (0, channels // groups) + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, name="fwd", **self._kwargs)
        else:
            act = op(x, weight, bias, name="fwd", **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if hasattr(self, "out_pad") and self.out_pad != (0,) * len_kernel_size:
            s += ", output_padding={out_pad}".format(out_pad=self.out_pad)
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += ", {}".format(self.act)
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(
                            shape[1] if shape[1] else None, shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super(Conv1D, self).__init__(
            channels, _sized(kernel_size, 1), strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super(Conv2D, self).__init__(
            channels, _sized(kernel_size, 2), strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super(Conv3D, self).__init__(
            channels, _sized(kernel_size, 3), strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _sized(kernel_size, 1)
        output_padding = _sized(output_padding, 1, "output_padding")
        super(Conv1DTranspose, self).__init__(
            channels, kernel_size, strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution", adj=output_padding,
            **kwargs)
        self.outpad = output_padding


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _sized(kernel_size, 2)
        output_padding = _sized(output_padding, 2, "output_padding")
        super(Conv2DTranspose, self).__init__(
            channels, kernel_size, strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution", adj=output_padding,
            **kwargs)
        self.outpad = output_padding


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _sized(kernel_size, 3)
        output_padding = _sized(output_padding, 3, "output_padding")
        super(Conv3DTranspose, self).__init__(
            channels, kernel_size, strides, padding, dilation, groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution", adj=output_padding,
            **kwargs)
        self.outpad = output_padding


class _Pooling(HybridBlock):
    """Base pooling (gluon/nn/conv_layers.py:671)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=None, **kwargs):
        super(_Pooling, self).__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        s = "{name}(size={kernel}, stride={stride}, padding={pad}" \
            ", ceil_mode={ceil_mode}, global_pool={global_pool}, pool_type={pool_type})"
        return s.format(
            name=self.__class__.__name__,
            ceil_mode=self._kwargs["pooling_convention"] == "full",
            **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        assert layout == "NCW", "Only NCW layout is supported"
        super(MaxPool1D, self).__init__(
            _sized(pool_size, 1, "pool_size"), strides, padding, ceil_mode, False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super(MaxPool2D, self).__init__(
            _sized(pool_size, 2, "pool_size"), strides, padding, ceil_mode, False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        assert layout == "NCDHW", "Only NCDHW layout is supported"
        super(MaxPool3D, self).__init__(
            _sized(pool_size, 3, "pool_size"), strides, padding, ceil_mode, False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        assert layout == "NCW", "Only NCW layout is supported"
        super(AvgPool1D, self).__init__(
            _sized(pool_size, 1, "pool_size"), strides, padding, ceil_mode, False, "avg", layout,
            count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        assert layout == "NCHW", "Only NCHW layout is supported"
        super(AvgPool2D, self).__init__(
            _sized(pool_size, 2, "pool_size"), strides, padding, ceil_mode, False, "avg", layout,
            count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        assert layout == "NCDHW", "Only NCDHW layout is supported"
        super(AvgPool3D, self).__init__(
            _sized(pool_size, 3, "pool_size"), strides, padding, ceil_mode, False, "avg", layout,
            count_include_pad, **kwargs)


def _global_pool(name, ndim, pool_type, want_layout):
    """Build a Global{Max,Avg}Pool{1,2,3}D class: full-spatial pooling
    is one flag on _Pooling, so the six variants differ only in their
    (ndim, type, layout) triple."""
    def __init__(self, layout=want_layout, **kwargs):
        assert layout == want_layout, \
            "Only %s layout is supported" % want_layout
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True,
                          pool_type, **kwargs)
    cls = type(name, (_Pooling,), {"__init__": __init__})
    cls.__doc__ = "Global %s pooling over %dD spatial dims " \
                  "(gluon/nn/conv_layers.py Global*Pool)." \
                  % (pool_type, ndim)
    return cls


GlobalMaxPool1D = _global_pool("GlobalMaxPool1D", 1, "max", "NCW")
GlobalMaxPool2D = _global_pool("GlobalMaxPool2D", 2, "max", "NCHW")
GlobalMaxPool3D = _global_pool("GlobalMaxPool3D", 3, "max", "NCDHW")
GlobalAvgPool1D = _global_pool("GlobalAvgPool1D", 1, "avg", "NCW")
GlobalAvgPool2D = _global_pool("GlobalAvgPool2D", 2, "avg", "NCHW")
GlobalAvgPool3D = _global_pool("GlobalAvgPool3D", 3, "avg", "NCDHW")


class ReflectionPad2D(HybridBlock):
    """Pads the input with the reflection of the boundary
    (gluon/nn/conv_layers.py:1151)."""

    def __init__(self, padding=0, **kwargs):
        super(ReflectionPad2D, self).__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
