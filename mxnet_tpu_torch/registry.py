"""Generic object registry (port of ``mxnet_tpu/registry.py``;
reference: python/mxnet/registry.py) — backs
the optimizer / initializer / metric `@register` + create-by-name
pattern."""

import json
import warnings

from .base import MXNetError

_REGISTRIES = {}

__all__ = ["get_register_func", "get_alias_func", "get_create_func"]


def _registry(base_class, nickname):
    return _REGISTRIES.setdefault((base_class, nickname), {})


def get_register_func(base_class, nickname):
    """Returns a @register decorator for subclasses of base_class."""

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        registry = _registry(base_class, nickname)
        if name in registry and registry[name] is not klass:
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s" % (
                    nickname, klass.__module__, klass.__name__, name,
                    nickname, registry[name].__module__,
                    registry[name].__name__))
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (
        base_class.__name__, nickname)
    return register


def get_alias_func(base_class, nickname):
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    def create(*args, **kwargs):
        if len(args) == 0:
            name = kwargs.pop(nickname)
        else:
            name = args[0]
            args = args[1:]
        if isinstance(name, base_class):
            assert len(args) == 0 and len(kwargs) == 0, \
                "%s is already an instance. Additional arguments are " \
                "invalid" % nickname
            return name
        if isinstance(name, dict):
            return create(**name)
        assert isinstance(name, str), "%s must be of string type" % nickname
        if name.startswith("["):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)
        registry = _registry(base_class, nickname)
        name = name.lower()
        if name not in registry:
            raise MXNetError("%s is not registered. Registered %ss: %s" % (
                name, nickname, ", ".join(sorted(registry))))
        return registry[name](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
