"""Bucketed sequence IO (port of ``mxnet_tpu/rnn/io.py``; reference:
python/mxnet/rnn/io.py).

`encode_sentences` builds/extends a vocabulary and integer-encodes token
lists; `BucketSentenceIter` buckets sentences by length, pads each to
its bucket size, and emits batches whose `bucket_key` drives
BucketingModule's per-length executor selection. Implementation is
vectorized: bucket assignment, padding, and the next-token label shift
all happen as whole-array numpy ops rather than per-sentence loops. The
host RNGs are the JAX package's (Python's ``random.shuffle`` of the batch
order, numpy's ``np.random.shuffle`` of each bucket's rows), so the same
seeds give the same batches in both packages. Batches are made on the
current context.
"""

import random

import numpy as np

from .. import ndarray
from ..io import DataBatch, DataDesc, DataIter


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Encode tokenized sentences to int lists, growing `vocab` as new
    tokens appear (or mapping them to `unknown_token` if given)."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sent in sentences:
        row = []
        for word in sent:
            code = vocab.get(word)
            if code is None:
                if unknown_token is not None:
                    code = vocab.get(unknown_token)
                    if code is None:
                        raise KeyError("unknown_token %r is not in the "
                                       "vocabulary" % unknown_token)
                else:
                    assert grow, "Unknown token %s" % word
                    if next_id == invalid_label:
                        next_id += 1
                    code = vocab[word] = next_id
                    next_id += 1
            row.append(code)
        encoded.append(row)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Pads each encoded sentence to the smallest bucket that fits and
    serves fixed-shape batches per bucket."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super(BucketSentenceIter, self).__init__()
        lengths = np.asarray([len(s) for s in sentences])
        if not buckets:
            hist = np.bincount(lengths)
            buckets = [length for length, count in enumerate(hist)
                       if count >= batch_size]
        buckets = sorted(buckets)

        # vectorized bucket assignment, then one padded matrix per bucket
        assignment = np.searchsorted(buckets, lengths)
        dropped = int((assignment == len(buckets)).sum())
        if dropped:
            import logging
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", dropped)
        per_bucket = []
        for b, size in enumerate(buckets):
            members = [sentences[i] for i in np.nonzero(assignment == b)[0]]
            mat = np.full((len(members), size), invalid_label, dtype=dtype)
            for r, sent in enumerate(members):
                mat[r, :len(sent)] = sent
            per_bucket.append(mat)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data = per_bucket
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        self.nddata = []
        self.ndlabel = []

        if self.major_axis == 0:
            default_shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            default_shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("Invalid layout %s: Must by NT (batch major) "
                             "or TN (time major)" % layout)
        self.provide_data = [DataDesc(name=data_name, shape=default_shape)]
        self.provide_label = [DataDesc(name=label_name,
                                       shape=default_shape)]

        # (bucket, row-offset) pairs — one per full batch
        self.idx = [(b, start)
                    for b, mat in enumerate(per_bucket)
                    for start in range(0, len(mat) - batch_size + 1,
                                       batch_size)]
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        self.nddata = []
        self.ndlabel = []
        for mat in self.data:
            np.random.shuffle(mat)
            # next-token labels: whole-matrix shift left, invalid at end
            shifted = np.concatenate(
                [mat[:, 1:],
                 np.full((len(mat), 1), self.invalid_label,
                         dtype=self.dtype)], axis=1)
            self.nddata.append(ndarray.array(mat, dtype=self.dtype))
            self.ndlabel.append(ndarray.array(shifted, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        bucket, start = self.idx[self.curr_idx]
        self.curr_idx += 1
        rows = slice(start, start + self.batch_size)
        data = self.nddata[bucket][rows]
        label = self.ndlabel[bucket][rows]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[bucket],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=label.shape)])
