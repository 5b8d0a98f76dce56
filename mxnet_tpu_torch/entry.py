"""The port's entry points for ResNet-50 v1, the JAX package's flagship:
``entry()``, the counterpart of ``__graft_entry__.entry()``,
``build_train_step``, that of ``bench.py``'s ``build_train_step`` in its
default fold-cast layout, and ``real_data``, that of ``bench.py
--real-data`` (``_make_record_dataset`` and ``real_data_main``): the
same step fed by ``io.ImageRecordIter`` from a RecordIO file it writes.
``module_fit`` is the counterpart of
``examples/image_classification/train_imagenet.py --benchmark 1`` through
``common.fit``: ``Module.fit`` of the example's symbolic ResNet
(``symbols.resnet``) on ``synthetic_iter``'s data through a kvstore.

``entry`` and ``build_train_step`` trace the Gluon model-zoo net through
``utils.functionalize_block`` and run its graph function with torch ops
(cuDNN and cuBLAS on the card, in MXNet's NCHW layout). They run on the current context, ``gpu(0)``
unless the caller says ``with cpu():`` or passes ``ctx``. Parameters are
drawn by ``initializer.Xavier`` from the device's generator
(``random.generator``); the JAX package's can be copied into the returned
tensors by name (``models.convert.graph_params_from_numpy``).
"""

import io as _io
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import callback
from . import initializer
from . import io
from . import lr_scheduler
from . import module
from . import ndarray as nd
from . import recordio
from .symbols import resnet as resnet_symbols
from .context import current_context
from .gluon.model_zoo import vision
from .utils import functionalize_block

__all__ = ["entry", "build_train_step", "make_record_dataset", "record_iter",
           "real_data", "synthetic_iter", "module_fit"]

MOMENTUM = 0.9
SEED = 0            # entry's example input; real_data's records and draws
CLASSES = 1000
WARMUP = 2          # real_data's untimed steps before each timed run
# train_imagenet.py's defaults (its set_defaults and common.add_fit_args)
FIT_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FIT_LR_STEP_EPOCHS = (30, 60, 80)
FIT_LR_FACTOR = 0.1
FIT_EXAMPLES = 1281167


def _resnet50(classes, ctx):
    net = vision.resnet50_v1(classes=classes)
    net.initialize(initializer.Xavier(), ctx=ctx)
    return net


def entry(batch=8, image_size=224, ctx=None):
    """Forward step of ResNet-50 v1 (1000 classes) in inference mode.

    Returns (fn, (args, aux, x)): ``fn(args, aux, x) -> logits`` over the
    traced graph, with the parameter dicts of ``functionalize_block`` and
    an example input of ``batch`` x 3 x ``image_size``² drawn uniformly
    from [0, 1) by a generator seeded with ``SEED`` on the context's
    device."""
    ctx = ctx if ctx is not None else current_context()
    device = ctx.torch_device
    net = _resnet50(CLASSES, ctx)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.rand((batch, 3, image_size, image_size), generator=gen,
                   device=device)
    graph_fn, data_names, args, aux = functionalize_block(
        net, nd.NDArray(x, ctx), is_train=False)

    def fn(args, aux, x):
        inputs = dict(args)
        inputs[data_names[0]] = x
        outs, _ = graph_fn(inputs, aux)
        return outs[0]

    return fn, (args, aux, x)


def build_train_step(batch, image_size=224, classes=CLASSES, lr=0.1,
                     ctx=None):
    """ResNet-50 v1 training step, SGD with momentum 0.9, in bench.py's
    fold-cast layout: the graph runs in bf16 on persistent bf16 weights
    (the gradients are taken with respect to them), with fp32 masters.

    Returns (step, state, mom, aux): ``state = (args_f32, args_bf16)``
    and ``mom`` (fp32) are dicts by parameter name, ``aux`` the fp32
    BatchNorm running statistics. ``step(state, mom, aux, x, y) ->
    (state, mom, new_aux, loss)``: the input and the running statistics
    are cast to bf16, the logits to fp32 before ``log_softmax``, the loss
    is the mean NLL of the int labels ``y``; then ``mom = 0.9 mom +
    g.float()``, ``w32 -= lr mom``, ``w16 = w32.bfloat16()``, in place,
    and the new running statistics come back in fp32."""
    ctx = ctx if ctx is not None else current_context()
    net = _resnet50(classes, ctx)
    x0 = nd.zeros((batch, 3, image_size, image_size), ctx=ctx)
    graph_fn, data_names, args, aux = functionalize_block(
        net, x0, is_train=True)
    data = data_names[0]
    names = list(args)

    def step(state, mom, aux, x, y):
        args_f32, args_bf16 = state
        leaves = [args_bf16[n].detach().requires_grad_(True) for n in names]
        inputs = dict(zip(names, leaves))
        inputs[data] = x.to(torch.bfloat16)
        outs, aux_up = graph_fn(
            inputs, {k: v.to(torch.bfloat16) for k, v in aux.items()})
        logp = torch.log_softmax(outs[0].float(), dim=-1)
        loss = -logp.gather(-1, y.long()[:, None])[:, 0].mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for n, g in zip(names, grads):
                m = mom[n]
                m.mul_(MOMENTUM).add_(g.float())
                args_f32[n].sub_(lr * m)
                args_bf16[n].copy_(args_f32[n])
        new_aux = {k: v.float() for k, v in aux_up.items()}
        return state, mom, new_aux, loss.detach()

    state = ({n: args[n].clone() for n in names},
             {n: args[n].to(torch.bfloat16) for n in names})
    mom = {n: torch.zeros_like(args[n]) for n in names}
    return step, state, mom, dict(aux)


def make_record_dataset(directory, n_records, size):
    """Write ``n_records`` random images of (size + 32)^2 x 3 uint8 into
    ``directory``/train.rec and .idx, as ``bench.py``'s
    ``_make_record_dataset`` draws them (``RandomState(SEED)``: each
    image, then its label in [0, 1000)), each packed as a .npy payload
    whatever the host has (no PIL or cv2 needed to read it back). Returns
    (rec_path, idx_path)."""
    rec = os.path.join(directory, "train.rec")
    idx = os.path.join(directory, "train.idx")
    rng = np.random.RandomState(SEED)
    writer = recordio.MXIndexedRecordIO(idx, rec, "w")
    edge = size + 32
    for i in range(n_records):
        img = rng.randint(0, 255, (edge, edge, 3)).astype(np.uint8)
        buf = _io.BytesIO()
        np.save(buf, img)
        writer.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(rng.randint(0, CLASSES)), i, 0),
            buf.getvalue()))
    writer.close()
    return rec, idx


def record_iter(rec, idx, batch, size):
    """bench.py's feed: ``ImageRecordIter`` with shuffle, random crop and
    random mirror, on the current context."""
    return io.ImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, size, size),
        batch_size=batch, shuffle=True, rand_crop=True, rand_mirror=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def real_data(batch=128, image_size=224, steps=20, directory=None,
              ctx=None):
    """``bench.py --real-data`` on the port: ``build_train_step`` (1000
    classes, lr 0.1) trained through ``ImageRecordIter`` batches, then
    the same step on resident synthetic tensors, in one call.

    Writes max(batch * 4, 64) records with ``make_record_dataset`` into
    ``directory`` (a new temporary one, removed at the end, when None),
    seeds numpy's global state with ``SEED`` and builds the iterator
    (``record_iter``) on the context (``gpu(0)`` unless the caller says
    ``with cpu():`` or passes ``ctx``), whose batches reach the step as
    the iterator's tensors on that device (the labels cast to int32).
    After ``WARMUP`` fed steps it times ``steps`` fed steps, then
    ``WARMUP`` synthetic steps and ``steps`` timed ones on
    ``RandomState(0)`` tensors made on the device once, each run ending
    in a device sync.

    Returns a dict: ``fed_img_s`` and ``syn_img_s``, the feed-bound
    fraction ``1 - fed / syn``, ``loss_finite`` and ``loss`` (the last
    fed step's), ``feed_ms`` and ``step_ms`` (host ms per fed batch in
    the iterator's ``next()`` — decode, augment, stack and the copy to
    the device — and in the step's call), ``syn_step_ms``, ``records``,
    ``write_s`` and ``load_s`` (writing the file, and reading it into the
    iterator), ``native_read`` (whether the native library read the
    records, ``ImageRecordIter.native_read``), and
    ``first_data``/``first_label``, the first fed batch's NDArrays."""
    ctx = ctx if ctx is not None else current_context()
    device = ctx.torch_device
    n_records = max(batch * 4, 64)
    own_dir = directory is None
    directory = tempfile.mkdtemp(prefix="real_data_") if own_dir \
        else directory
    try:
        t0 = time.perf_counter()
        rec, idx = make_record_dataset(directory, n_records, image_size)
        write_s = time.perf_counter() - t0
        np.random.seed(SEED)
        t0 = time.perf_counter()
        with ctx:
            it = record_iter(rec, idx, batch, image_size)
        load_s = time.perf_counter() - t0
        step, state, mom, aux = build_train_step(batch, image_size,
                                                 ctx=ctx)
        run = {"state": state, "mom": mom, "aux": aux}
        feed_s, step_s, first = [], [], []

        def fed():
            t = time.perf_counter()
            try:
                b = it.next()
            except StopIteration:
                it.reset()
                b = it.next()
            t1 = time.perf_counter()
            if not first:
                first.extend((b.data[0], b.label[0]))
            run["state"], run["mom"], run["aux"], loss = step(
                run["state"], run["mom"], run["aux"], b.data[0]._data,
                b.label[0]._data.to(torch.int32))
            feed_s.append(t1 - t)
            step_s.append(time.perf_counter() - t1)
            return loss

        with ctx:
            for _ in range(WARMUP):
                fed()
            _sync(device)
            del feed_s[:], step_s[:]
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = fed()
            loss = float(loss)
            fed_s = time.perf_counter() - t0

        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.rand(batch, 3, image_size, image_size)
                             .astype(np.float32)).to(device)
        y = torch.from_numpy(rng.randint(0, CLASSES, (batch,))
                             .astype(np.int32)).to(device)

        def synthetic():
            run["state"], run["mom"], run["aux"], out = step(
                run["state"], run["mom"], run["aux"], x, y)
            return out

        for _ in range(WARMUP):
            synthetic()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            l2 = synthetic()
        float(l2)
        syn_s = time.perf_counter() - t0
    finally:
        if own_dir:
            shutil.rmtree(directory, ignore_errors=True)
    fed_rate = batch * steps / fed_s
    syn_rate = batch * steps / syn_s
    return {"fed_img_s": fed_rate, "syn_img_s": syn_rate,
            "feed_bound_fraction": 1.0 - fed_rate / syn_rate,
            "loss": loss, "loss_finite": bool(np.isfinite(loss)),
            "feed_ms": 1e3 * float(np.mean(feed_s)),
            "step_ms": 1e3 * float(np.mean(step_s)),
            "syn_step_ms": 1e3 * syn_s / steps, "records": n_records,
            "write_s": write_s, "load_s": load_s,
            "native_read": it.native_read,
            "first_data": first[0], "first_label": first[1]}


def synthetic_iter(num_classes, data_shape, batch_size, num_batches=40,
                   seed=0):
    """``examples/image_classification/common.py``'s synthetic dataset:
    uniform -1..1 float32 data and integer labels (as float32) from
    ``RandomState(seed)``, in a shuffling ``NDArrayIter`` whose batches
    are made on the current context (the shuffle draws from numpy's
    global generator)."""
    rng = np.random.RandomState(seed)
    n = batch_size * num_batches
    x = rng.uniform(-1, 1, (n,) + tuple(data_shape)).astype(np.float32)
    y = rng.randint(0, num_classes, (n,)).astype(np.float32)
    return io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                          label_name="softmax_label")


def module_fit(batch=128, image_size=224, num_layers=50, classes=CLASSES,
               kv_store="device", disp_batches=20, num_batches=None,
               ctx=None, train=None, arg_params=None, aux_params=None,
               batch_end_callback=None):
    """``train_imagenet.py --benchmark 1`` through ``common.fit``, at its
    defaults: the example's ResNet (``num_layers``, ``classes``, 3 x
    ``image_size`` squared) bound in a ``Module`` on ``ctx`` (the current
    context, ``gpu(0)`` unless the caller says otherwise; the example
    passes ``cpu()``), ``fit`` for one epoch of ``synthetic_iter``
    (``disp_batches + 4`` batches unless ``num_batches`` or ``train``
    says otherwise) with ``eval_metric="acc"``, SGD (``FIT_SGD``) under
    the MultiFactorScheduler of ``FIT_LR_STEP_EPOCHS`` x
    (``FIT_EXAMPLES // batch``) updates, ``Xavier(rnd_type="gaussian",
    factor_type="in", magnitude=2)`` for what ``arg_params``/
    ``aux_params`` (NDArray dicts) do not give, and
    ``Speedometer(batch, disp_batches)`` before ``batch_end_callback``.

    ``kv_store`` is the kvstore's name, passed to ``fit`` so that
    Module's ``_create_kvstore`` decides: on one context ``"device"`` and
    ``"local"`` make no store (a local updater) and ``"dist_sync"`` makes
    the dist store and updates on it. ``common.fit`` passes
    ``kvstore.create(name)`` instead, with which every store updates on
    the store: pass a ``KVStore`` object for that. Returns the fitted
    module."""
    ctx = ctx if ctx is not None else current_context()
    shape = (3, image_size, image_size)
    sym = resnet_symbols.get_symbol(classes, num_layers, shape)
    with ctx:
        if train is None:
            train = synthetic_iter(classes, shape, batch,
                                   num_batches=num_batches
                                   or disp_batches + 4)
        steps_per_epoch = max(1, FIT_EXAMPLES // batch)
        scheduler = lr_scheduler.MultiFactorScheduler(
            step=[max(1, e * steps_per_epoch) for e in FIT_LR_STEP_EPOCHS],
            factor=FIT_LR_FACTOR, base_lr=FIT_SGD["learning_rate"])
        mod = module.Module(sym, context=ctx)
        mod.fit(train, eval_metric="acc", kvstore=kv_store,
                optimizer="sgd",
                optimizer_params=dict(FIT_SGD, lr_scheduler=scheduler),
                initializer=initializer.Xavier(
                    rnd_type="gaussian", factor_type="in", magnitude=2),
                arg_params=arg_params, aux_params=aux_params,
                num_epoch=1,
                batch_end_callback=[callback.Speedometer(batch,
                                                         disp_batches)]
                + list(batch_end_callback or []))
    return mod
