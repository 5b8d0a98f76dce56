"""Symbol attribute scoping (port of ``mxnet_tpu/attribute.py``;
reference: python/mxnet/attribute.py AttrScope) — ``with
AttrScope(ctx_group='dev1'):`` attaches attributes (e.g. the
model-parallel __ctx_group__) to symbols created inside."""

import threading

__all__ = ["AttrScope"]


class AttrScope(object):
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """Merge user-supplied attrs with the scope's attrs."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
