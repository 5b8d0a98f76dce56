"""Contrib IO (port of ``mxnet_tpu/contrib/io.py``; reference:
contrib/io.py) — bridge a Gluon DataLoader into the DataIter interface
the Module API consumes."""

from ..io import DataIter, DataBatch, DataDesc

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Wrap a gluon.data.DataLoader yielding (data, label) pairs. The
    first batch is peeked for shapes and then SERVED (not discarded), so
    one-shot iterables keep every batch and re-iterable loaders don't
    pay a doubled first-batch cost."""

    def __init__(self, loader, data_name="data", label_name="softmax_label"):
        super(DataLoaderIter, self).__init__()
        self._loader = loader
        self._iter = iter(loader)
        self._data_name = data_name
        self._label_name = label_name
        self._peeked = next(self._iter)
        data, label = self._peeked[0], self._peeked[1]
        self.batch_size = data.shape[0]
        self.provide_data = [DataDesc(name=data_name, shape=data.shape)]
        self.provide_label = [DataDesc(name=label_name, shape=label.shape)]

    def reset(self):
        self._iter = iter(self._loader)
        self._peeked = None

    def next(self):
        if self._peeked is not None:
            data, label = self._peeked[0], self._peeked[1]
            self._peeked = None
        else:
            data, label = next(self._iter)
        return DataBatch([data], [label], pad=0,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
