"""Shared builder-factory for the zoo's named entry points (port of
``mxnet_tpu/gluon/model_zoo/vision/_factory.py``).

Every family exposes a flat set of `name -> fixed-config` constructors
(resnet50_v1, vgg16_bn, mobilenet0_25, ...); each is the family getter
with some arguments pinned. One helper stamps them all so identity
metadata (__name__/__qualname__/__doc__) is handled in one place.
"""


def entry_point(name, doc, getter, *pinned, **fixed_kwargs):
    """A public constructor `name` that calls ``getter(*pinned,
    **fixed_kwargs, **caller_kwargs)``."""
    def build(**kwargs):
        merged = dict(fixed_kwargs)
        merged.update(kwargs)
        return getter(*pinned, **merged)
    build.__name__ = build.__qualname__ = name
    build.__doc__ = doc
    return build
