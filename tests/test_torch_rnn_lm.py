"""The port's two recurrent language models (``entry.word_lm``, upstream
MXNet's ``example/gluon/word_language_model``, and
``entry.bucketing_lm``, its ``example/rnn/bucketing/lstm_bucketing.py``)
at a small width against the same nets built on the JAX package: the
same seeded tokens and starting parameters, dropout 0 (the two
packages' masks come from different streams), three steps, and the
losses and every parameter after them within fp32 atol 1e-5 / rtol 1e-4.
The models' ``.params`` files and the bucketing model's rnn checkpoints
load in either package."""

import random

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import entry
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-4
# the word LM at a small width; lr 10 rather than upstream's 20, at which
# this 16-wide net's loss rises over its first three steps (4.16 to 4.54)
WORD = dict(vocab=64, emsize=16, nhid=16, nlayers=2, dropout=0.0, bptt=5, batch_size=4, lr=10.0)
BUCKET = dict(vocab=32, num_embed=8, num_hidden=8, num_layers=2,
              buckets=(4, 8, 12), batch_size=4, batches=3, lr=0.1)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def jax_word_lm_model(spec, prefix):
    """Upstream ``model.py``'s ``RNNModel`` on the JAX package."""
    gluon, nn, rnn = jmx.gluon, jmx.gluon.nn, jmx.gluon.rnn
    nhid = spec["nhid"]

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(spec["dropout"])
                self.encoder = nn.Embedding(spec["vocab"], spec["emsize"])
                self.rnn = rnn.LSTM(nhid, spec["nlayers"],
                                    dropout=spec["dropout"],
                                    input_size=spec["emsize"])
                self.decoder = nn.Dense(spec["vocab"], in_units=nhid,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, nhid))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel(prefix=prefix)


def jax_word_lm_steps(model, source, spec, steps):
    """Upstream ``train.py``'s loop on the JAX package: the losses."""
    trainer = jmx.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": spec["lr"],
                                 "momentum": 0, "wd": 0})
    loss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(model.collect_params().values())
    b, bptt = spec["batch_size"], spec["bptt"]
    hidden = model.begin_state(func=jmx.nd.zeros, batch_size=b)
    losses = []
    for i in range(steps):
        data = jmx.nd.array(source[i * bptt:(i + 1) * bptt])
        target = jmx.nd.array(source[i * bptt + 1:(i + 1) * bptt + 1]
                              .reshape(-1))
        hidden = [h.detach() for h in hidden]
        with jmx.autograd.record():
            output, hidden = model(data, hidden)
            L = loss(output, target)
            L.backward()
        jmx.gluon.utils.clip_global_norm(
            [p.grad() for p in params], spec["clip"] * bptt * b)
        trainer.step(bptt * b)
        losses.append(float(L.mean().asscalar()))
    return losses


def _params(block):
    return {k: v.data().asnumpy()
            for k, v in block._collect_params_with_prefix().items()}


@pytest.mark.parametrize("hybridize", [True, False])
def test_word_lm_matches_jax(tmp_path, hybridize):
    """Three steps of ``entry.word_lm``'s loop against upstream's loop on
    the JAX package, from the port's initial parameters through a
    ``.params`` file."""
    steps = 3
    run = entry.word_lm_setup(ctx=mt.cpu(), seed=3, hybridize=hybridize,
                              windows=steps, **WORD)
    spec = run.spec
    path = str(tmp_path / "word_lm.params")
    run.model.save_parameters(path)
    jmodel = jax_word_lm_model(spec, prefix="jlm_")
    jmodel.load_parameters(path, ctx=jmx.cpu())
    if hybridize:
        jmodel.hybridize()
    start = _params(run.model)
    np.testing.assert_array_equal(_params(jmodel)["encoder.weight"],
                                  start["encoder.weight"])
    got = [float(run.step(i).mean().asscalar()) for i in range(steps)]
    want = jax_word_lm_steps(jmodel, run.source.asnumpy(), spec, steps)
    _close(got, want)
    assert got[-1] < got[0]
    # the tied decoder shares the embedding's weight
    assert run.model.decoder.weight is run.model.encoder.weight
    jp = _params(jmodel)
    for name, value in _params(run.model).items():
        _close(value, jp[name])
        assert not np.array_equal(value, start[name]) or "bias" in name


def test_word_lm_entry_loss_starts_near_uniform():
    """``entry.word_lm`` reads each step's mean token loss back; the first
    sits near ln(vocab) (Xavier's logits are small) and all are finite."""
    run, losses = entry.word_lm(steps=3, ctx=mt.cpu(), seed=1, **WORD)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert abs(losses[0] - np.log(WORD["vocab"])) < 0.5
    assert run.hidden[0].shape == (WORD["nlayers"], WORD["batch_size"],
                                   WORD["nhid"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_word_lm_params_file_interchange(tmp_path, writer, reader):
    """The word LM's ``.params`` saved by one package loads into the other
    package's model and gives the same logits."""
    spec = dict(entry.WORD_LM, **WORD)
    tokens = entry.lm_tokens(5 * 4, WORD["vocab"], seed=2).reshape(5, 4)
    models = {"port": entry.word_lm_model(
                  spec["vocab"], spec["emsize"], spec["nhid"],
                  spec["nlayers"], 0.0, prefix="plm_"),
              "jax": jax_word_lm_model(spec, prefix="jlm_")}
    pkgs = {"port": mt, "jax": jmx}
    models[writer].initialize(pkgs[writer].init.Xavier())
    path = str(tmp_path / "lm.params")
    models[writer].save_parameters(path)
    models[reader].load_parameters(path, ctx=pkgs[reader].cpu())
    outs = {}
    for key, model in models.items():
        mx = pkgs[key]
        hidden = model.begin_state(func=mx.nd.zeros, batch_size=4)
        out, _ = model(mx.nd.array(tokens.astype(np.float32)), hidden)
        outs[key] = out.asnumpy()
    _close(outs["port"], outs["jax"])


def _bucketing_args(spec, seed=5):
    """Seeded starting parameters for every argument of the bucketing
    model's largest bucket (the weights every bucket shares)."""
    stack = mt.rnn.SequentialRNNCell()
    for i in range(spec["num_layers"]):
        stack.add(mt.rnn.LSTMCell(num_hidden=spec["num_hidden"],
                                  prefix="lstm_l%d_" % i))
    T, b = max(spec["buckets"]), spec["batch_size"]
    data = mt.sym.Variable("data")
    embed = mt.sym.Embedding(data=data, input_dim=spec["vocab"],
                             output_dim=spec["num_embed"], name="embed")
    outputs, _ = stack.unroll(T, inputs=embed, merge_outputs=True)
    pred = mt.sym.FullyConnected(
        data=mt.sym.Reshape(outputs, shape=(-1, spec["num_hidden"])),
        num_hidden=spec["vocab"], name="pred")
    shapes, _, _ = pred.infer_shape(data=(b, T))
    rs = np.random.RandomState(seed)
    return {n: (rs.uniform(-0.3, 0.3, s)).astype(np.float32)
            for n, s in zip(pred.list_arguments(), shapes) if n != "data"}


def jax_bucketing_fit(spec, sentences, arg_params, on_batch):
    """``lstm_bucketing.py`` on the JAX package."""
    sym = jmx.sym
    nh = spec["num_hidden"]
    stack = jmx.rnn.SequentialRNNCell()
    for i in range(spec["num_layers"]):
        stack.add(jmx.rnn.LSTMCell(num_hidden=nh, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        embed = sym.Embedding(data=sym.Variable("data"),
                              input_dim=spec["vocab"],
                              output_dim=spec["num_embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.FullyConnected(data=sym.Reshape(outputs, shape=(-1, nh)),
                                  num_hidden=spec["vocab"], name="pred")
        label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
        return (sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))

    train = jmx.rnn.BucketSentenceIter(sentences, spec["batch_size"],
                                       buckets=list(spec["buckets"]),
                                       invalid_label=spec["invalid_label"])
    mod = jmx.mod.BucketingModule(sym_gen=sym_gen,
                                  default_bucket_key=train.default_bucket_key,
                                  context=jmx.cpu())
    mod.fit(train_data=train,
            eval_metric=jmx.metric.Perplexity(spec["invalid_label"]),
            kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": spec["lr"],
                              "momentum": spec["mom"], "wd": spec["wd"]},
            initializer=jmx.init.Xavier(factor_type="in", magnitude=2.34),
            arg_params={k: jmx.nd.array(v) for k, v in arg_params.items()},
            allow_missing=True, num_epoch=1, batch_end_callback=[on_batch])
    return mod, stack


def _metric_log(out):
    def on_batch(param):
        out.append(param.eval_metric.get()[1])
    return on_batch


def test_bucketing_lm_matches_jax():
    """``entry.bucketing_lm`` against ``lstm_bucketing.py`` on the JAX
    package: the same sentences, host seeds and starting parameters give
    the same batches, perplexity after every batch and final parameters;
    each bucket is bound once."""
    spec = dict(entry.BUCKETING_LM, **BUCKET)
    args = _bucketing_args(spec)
    sentences = entry.bucketing_sentences(spec, seed=4)
    got, want = [], []
    random.seed(11)
    np.random.seed(11)
    mod, stack, train = entry.bucketing_lm(
        ctx=mt.cpu(), seed=4, batch_end_callback=[_metric_log(got)],
        arg_params={k: mt.nd.array(v) for k, v in args.items()}, **BUCKET)
    random.seed(11)
    np.random.seed(11)
    jmod, _ = jax_bucketing_fit(spec, sentences, args, _metric_log(want))
    assert len(got) == spec["batches"] and np.isfinite(got).all()
    _close(got, want)
    assert sorted(mod._buckets) == sorted(jmod._buckets) == \
        sorted(spec["buckets"])
    tp, _ = mod.get_params()
    jp, _ = jmod.get_params()
    assert sorted(tp) == sorted(jp) == sorted(args)
    for k in args:
        _close(tp[k].asnumpy(), jp[k].asnumpy())
        assert not np.array_equal(tp[k].asnumpy(), args[k])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_bucketing_rnn_checkpoint_interchange(tmp_path, writer, reader):
    """The bucketing model's cell stack through ``save_rnn_checkpoint`` in
    one package and ``load_rnn_checkpoint`` in the other: per-gate
    arrays on disk, the stack's packed arrays back bitwise."""
    pkgs = {"port": mt, "jax": jmx}
    spec = dict(entry.BUCKETING_LM, **BUCKET)
    args = _bucketing_args(spec)

    def stack_of(mx):
        stack = mx.rnn.SequentialRNNCell()
        for i in range(spec["num_layers"]):
            stack.add(mx.rnn.LSTMCell(num_hidden=spec["num_hidden"],
                                      prefix="lstm_l%d_" % i))
        return stack

    wmx, rmx = pkgs[writer], pkgs[reader]
    wstack = stack_of(wmx)
    out, _ = wstack.unroll(3, inputs=wmx.sym.Variable("data"),
                           merge_outputs=True)
    prefix = str(tmp_path / "bucket")
    wmx.rnn.save_rnn_checkpoint(wstack, prefix, 2, out, {
        k: wmx.nd.array(v) for k, v in args.items()}, {})
    on_disk = rmx.nd.load("%s-0002.params" % prefix)
    assert "arg:lstm_l0_i2h_f_weight" in on_disk
    assert "arg:lstm_l0_i2h_weight" not in on_disk
    sym2, args2, aux2 = rmx.rnn.load_rnn_checkpoint(stack_of(rmx), prefix, 2)
    assert sorted(args2) == sorted(args) and aux2 == {}
    for k, v in args.items():
        np.testing.assert_array_equal(args2[k].asnumpy(), v)
    assert sym2.list_arguments() == out.list_arguments()
