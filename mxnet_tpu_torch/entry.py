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
``elastic_worker`` is one generation of an elastic job (the counterpart
of ``examples/elastic_training.py``'s ``elastic_worker``), run by the
port's launcher as ``python -m mxnet_tpu_torch.entry --elastic-worker``;
``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.dryrun_multichip`` on an ``n``-rank world of processes
(each runs ``python -m mxnet_tpu_torch.entry --dryrun-rank``).
``word_lm`` is upstream MXNet's ``example/gluon/word_language_model``
(``model.py``'s ``RNNModel``, ``train.py``'s loop) and ``bucketing_lm``
its ``example/rnn/bucketing/lstm_bucketing.py``, each at its published
widths unless told otherwise, on tokens made from a seed.

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
import sys
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
from .context import current_context, resolve_device
from .gluon.model_zoo import vision
from .utils import functionalize_block

__all__ = ["entry", "build_train_step", "make_record_dataset", "record_iter",
           "real_data", "synthetic_iter", "module_fit", "elastic_worker",
           "elastic_tokens", "dryrun_multichip", "lm_tokens",
           "word_lm_model", "word_lm_setup", "word_lm",
           "bucketing_sentences", "bucketing_lm"]

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


# ------------------------------------------------------ elastic worker ---

# examples/elastic_training.py's elastic worker: its toy model, its fixed
# token set (64 rows from RandomState(7)) and 8 global rows a step
ELASTIC_TOY_CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1,
                       d_ff=32, max_len=32)
ELASTIC_ROWS = 8
ELASTIC_DATA = dict(rows=64, seed=7)
ELASTIC_LR = 0.1
# an absent peer's exit code (the elastic worker's `solo` mode)
ABSENT_PEER_EXIT_CODE = 31
# a collective's time limit in an elastic world, well past the heartbeat
# staleness window, so that the backend's watchdog does not end a
# survivor before its shrink is committed
ELASTIC_COLLECTIVE_TIMEOUT_S = 300.0


def elastic_tokens(cfg, spec=ELASTIC_DATA):
    """The worker's fixed token set, as the example makes it."""
    return np.random.RandomState(spec["seed"]).randint(
        0, cfg.vocab_size, (spec["rows"], cfg.max_len)).astype(np.int32)


def _say(line):
    """One line to stdout in one write, so that the lines of the ranks
    sharing a pipe never interleave."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _param_l1(params):
    return float(sum(float(p.detach().abs().sum()) for p in
                     params.parameters()))


def elastic_worker(ckpt_dir, cfg=None, steps=8, gen_steps=2, lr=ELASTIC_LR,
                   allow_partial=False, keep_global_batch=False,
                   heartbeat_s=None, miss=None, keep_generations=None,
                   chaos_spec=None, solo=False, device=None):
    """One generation of an elastic job under
    ``mxnet_tpu_torch.tools.elastic_launch`` (the port's counterpart of
    ``examples/elastic_training.py``'s ``elastic_worker``). Returns the
    process's exit code; a shrink or a boundary with a coordinator leaves
    the process from inside (44, 45).

    The rank, world and generation come from the launcher's variables.
    The worker resumes through ``checkpoint.resume_elastic`` (the newest
    shard set or checkpoint; ``MXNET_ELASTIC_RESUME_GEN`` pins a shard
    generation) or starts fresh from ``init_params(cfg, seed=0)``, reads
    ``elastic_tokens(cfg)`` through an ``io.NDArrayIter`` cursor, 8 global
    rows a step whatever the world, and trains with
    ``elastic.make_accum_train_step`` at ``accum =
    accumulation_factor(base_world, world)`` under ``keep_global_batch``.
    Above a world of one it joins the process group (NCCL on the GPU,
    gloo on the CPU) and installs an ``ElasticCoordinator`` whose provider
    holds the last completed step, with the CUDA event recorded after it;
    it saves a shard set at a boundary and at the end. ``cfg`` is a
    ``TransformerConfig`` (the example's toy model by default).
    ``heartbeat_s``, ``miss`` and ``keep_generations`` are the JAX
    package's knobs (2 s, 3, 2); ``chaos_spec`` installs chaos rules (the
    launcher's ``--chaos-spec`` reaches the worker as ``MXNET_CHAOS``).

    ``solo`` is a one-card world: rank 0 trains alone on the global batch
    without a process group, and every other rank exits at once with
    ``ABSENT_PEER_EXIT_CODE`` and no heartbeat, a peer whose host never
    came up. Rank 0's monitor thread then finds it dead on the sideband,
    as it would a real one.

    Machine-checkable lines: ``LOSS g<gen> r<rank> <step> <float hex>``,
    ``DATA g<gen> r<rank> <step> <row_lo> <row_hi>``, ``LAUNCHES
    g<gen> r<rank> <step> <flash_fwd> <flash_bwd_dq> <flash_bwd_dkv>``
    (the step's kernel launches), ``STEPMS g<gen> r<rank> <step> <ms>``,
    ``TTR <ms>`` (after the first step of a generation that came up in a
    recovery: from the failure's record to that step) and ``final
    g<gen> r<rank> step <n> param_l1 <x> fingerprint <crc>``."""
    from . import kernels, parallel
    from .context import Context
    from .models import checkpoint as ckpt
    from .models import transformer as tf
    from .observability import chaos
    from .parallel import elastic

    rank, world = elastic.rank_env(), elastic.world_env()
    gen = elastic.generation_env()
    base_world = int(os.environ.get("MXNET_ELASTIC_BASE_WORLD", world))
    if solo and rank != 0:
        _say("simulated peer: rank %d of generation %d never starts (no "
             "heartbeat; exit %d)" % (rank, gen, ABSENT_PEER_EXIT_CODE))
        return ABSENT_PEER_EXIT_CODE
    if chaos_spec:
        chaos.install(chaos_spec)
    cfg = cfg or tf.TransformerConfig(**ELASTIC_TOY_CFG)
    joined = not solo and world > 1 and parallel.init_distributed(
        timeout=ELASTIC_COLLECTIVE_TIMEOUT_S)
    device = resolve_device(device)
    mesh = parallel.make_mesh({"dp": world, "tp": 1, "sp": 1, "ep": 1},
                              device=device) if joined else None
    accum = elastic.accumulation_factor(base_world, world) \
        if keep_global_batch else 1
    rows = ELASTIC_ROWS

    def fresh():
        p = tf.init_params(cfg, seed=0, device=device)
        if mesh is not None:
            p = tf.shard_params(p, cfg, mesh)
        return cfg, p, tf.init_momentum(p), 0, {}

    resume_gen = os.environ.get("MXNET_ELASTIC_RESUME_GEN")
    _, params, mom, start, extras = ckpt.resume_elastic(
        ckpt_dir, mesh, init=fresh, expect_generation=gen,
        allow_partial=allow_partial,
        generation=int(resume_gen) if resume_gen else None, device=device)
    data = elastic_tokens(cfg)
    host = Context("cpu", 0)
    with host:
        it = io.NDArrayIter(data, batch_size=rows,
                            last_batch_handle="discard")
    if extras.get("cursor"):
        it.load_state_dict(elastic.cursor_from_json(extras["cursor"]))
    if extras.get("rng"):
        elastic.restore_rng(extras["rng"])
    if start:
        _say("resumed g%d r%d from step %d (world %d, accum %d)"
             % (gen, rank, start, world, accum))

    live = {"params": params, "mom": mom, "step": start,
            "cursor": it.state_dict(), "ready": None}

    def provider():
        return {"cfg": cfg, "params": live["params"],
                "momentum": live["mom"], "step": live["step"],
                "cursor": elastic.jsonable_cursor(live["cursor"]),
                "rng": elastic.capture_rng(), "ready": live["ready"],
                "metadata": {"elastic": {"generation": gen,
                                         "world": world}}}

    coord = None
    if elastic.enabled() and world > 1:
        coord = elastic.install_coordinator(elastic.ElasticCoordinator(
            ckpt_dir, provider, interval=heartbeat_s, miss=miss,
            keep_generations=keep_generations, monitor=not joined))
        if joined:
            # every rank has beaten once it passes the barrier: only then
            # may a missing heartbeat mean a dead peer
            torch.distributed.barrier()
            coord.start()
    ckpt.install_emergency_checkpoint(ckpt_dir, provider, on_watchdog=False)

    def save_shard(step):
        ckpt.save_shard_checkpoint(
            ckpt_dir, cfg, live["params"], momentum=live["mom"], step=step,
            rank=rank, world=world, generation=gen + 1,
            cursor=elastic.jsonable_cursor(live["cursor"]),
            rng=elastic.capture_rng(), base_world=base_world,
            keep_generations=keep_generations, ready=live["ready"])

    step_fn = elastic.make_accum_train_step(cfg, mesh, lr=lr, accum=accum)
    cuda = device.type == "cuda"
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    gen_steps_done = 0
    for step in range(start + 1, steps + 1):
        row_lo = int(it.cursor) + rows      # the rows this batch takes
        with host:
            batch = it.next().data[0].asnumpy().astype(np.int32)
        micro = torch.from_numpy(batch.reshape(
            accum, rows // accum, cfg.max_len)).to(device)
        before = [kernels.launches[n] for n in names]
        t0 = time.perf_counter()
        try:
            params, mom, loss = step_fn(params, mom, micro)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record()
            loss_val = float(loss)          # the step COMPLETED
        except Exception:
            # a gloo peer's death can surface as a collective error rather
            # than a hang: membership is still the heartbeats' verdict, so
            # poll out the staleness window before concluding
            if coord is not None:
                hb = elastic.heartbeat_s(heartbeat_s)
                deadline = time.time() + hb * (
                    elastic.miss_threshold(miss) + 2)
                while time.time() < deadline:
                    dead = coord.dead()
                    if dead:
                        coord.shrink(dead)  # exits 44
                    time.sleep(hb / 2)
            raise
        step_ms = 1e3 * (time.perf_counter() - t0)
        # print BEFORE publishing the step to the capture: a shrink landing
        # in between resumes from the previous step and prints this step's
        # lines again, the same (at-least-once logging, the update applied
        # once)
        _say("DATA g%d r%d %d %d %d" % (gen, rank, step, row_lo,
                                        row_lo + rows))
        _say("LOSS g%d r%d %d %s" % (gen, rank, step, loss_val.hex()))
        _say("LAUNCHES g%d r%d %d %s" % (
            gen, rank, step, " ".join(str(kernels.launches[n] - b)
                                      for n, b in zip(names, before))))
        _say("STEPMS g%d r%d %d %.3f" % (gen, rank, step, step_ms))
        live.update(params=params, mom=mom, step=step,
                    cursor=it.state_dict(), ready=ready)
        if gen_steps_done == 0 and rank == 0:
            ttr = elastic.observe_recovery()
            if ttr is not None:
                _say("TTR %.1f" % ttr)
        if coord is not None:
            coord.beat(step)
            coord.check()
        chaos.fire("train.step", step=step)   # injected kills land here
        gen_steps_done += 1
        if step < steps and gen_steps and gen_steps_done >= gen_steps \
                and world < base_world:
            # a generation boundary: hand back so the recovered host can
            # rejoin; the g+1 shard set carries the exact cursor
            if coord is not None and not coord.stop():
                coord.wait_for_shrink()     # the shrink leaves with 44
            save_shard(step)
            _say("boundary g%d r%d at step %d" % (gen, rank, step))
            if coord is not None:
                coord.leave_at_boundary()
            return elastic.BOUNDARY_EXIT_CODE
    # disarm the shrink first: this rank is done, and a shrink that began
    # on the monitor thread captured an earlier step and leaves with 44
    if coord is not None and not coord.stop():
        coord.wait_for_shrink()
    save_shard(steps)
    ckpt.uninstall_emergency_checkpoint()
    fingerprint = ckpt.fingerprint_entries(
        ("p." + n, ckpt._dtype_name(t), tuple(t.shape),
         ckpt._to_numpy(t.detach().cpu()).tobytes())
        for n, t in tf.flat_tensors(params).items())
    _say("final g%d r%d step %d param_l1 %.6f fingerprint %s"
         % (gen, rank, steps, _param_l1(params), fingerprint))
    return 0


# ------------------------------------------------------ multichip dryrun --

def _dryrun_axes(n):
    """``__graft_entry__.dryrun_multichip``'s factoring: sp, tp, then ep
    take a factor of 2 each before dp; dp absorbs the rest."""
    axes = {"dp": 1, "tp": 1, "sp": 1, "ep": 1}
    for name in ("sp", "tp", "ep", "dp"):
        if n % 2 == 0 and n > 1:
            axes[name] *= 2
            n //= 2
    axes["dp"] *= n
    return axes


def _dryrun_pp_axes(n):
    axes = {"pp": 2, "sp": 1, "tp": 1, "dp": 1, "ep": 1}
    n //= 2
    for name in ("sp", "tp", "dp"):
        if n % 2 == 0 and n > 1:
            axes[name] *= 2
            n //= 2
    axes["dp"] *= n
    return axes


def _dryrun_rank(n, store, out):
    """One rank of :func:`dryrun_multichip`: the three legs, rank 0
    writing their losses to ``out``."""
    import json as _json
    from . import autograd, gluon, parallel
    from . import random as _random
    from .context import Context, gpu
    from .models import transformer as tf

    rank = int(os.environ["MXNET_TPU_PROC_ID"])
    parallel.init_distributed("file://" + store, n, rank)
    cuda = torch.cuda.is_available()
    device = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    ctx = gpu(device.index) if cuda else Context("cpu", 0)
    losses = {}

    def report(what, mesh_axes, loss):
        if not np.isfinite(loss):
            raise AssertionError("non-finite %s loss in the multichip dryrun"
                                 % what)
        losses[what] = loss
        if rank == 0:
            print("dryrun_multichip(%d): %s mesh=%s loss=%.4f OK"
                  % (n, what, mesh_axes, loss), flush=True)

    # the LM step under dp/tp/sp/ep: experts really sharded over ep
    axes = _dryrun_axes(n)
    mesh = parallel.make_mesh(axes, device=device)
    cfg = tf.TransformerConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        n_experts=max(2, axes["ep"]), max_len=32, n_kv_heads=2, rope=True,
        use_ring_attention=axes["sp"] > 1, remat_layers=True)
    params = tf.shard_params(tf.init_params(cfg, seed=0, device=device),
                             cfg, mesh)
    momentum = tf.init_momentum(params)
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (max(4, 2 * axes["dp"]), cfg.max_len))
    _, _, loss = tf.make_train_step(cfg, mesh, lr=1e-2)(params, momentum,
                                                         tokens)
    report("lm", axes, float(loss))

    # ResNet-50 data parallel through the Gluon Trainer over dist_sync:
    # each rank its block of the global batch, the gradients summed
    rb = 2 * n
    _random.seed(0)
    with ctx:
        rnet = vision.resnet50_v1(classes=10)
        rnet.initialize(initializer.Xavier())
        rnet.hybridize()
        trainer = gluon.Trainer(rnet.collect_params(), "sgd",
                                {"learning_rate": 0.05, "momentum": 0.9},
                                kvstore="dist_sync")
        rx = np.random.RandomState(2).rand(rb, 3, 32, 32).astype("float32")
        ry = np.random.RandomState(3).randint(0, 10, (rb,)).astype("float32")
        lo, hi = 2 * rank, 2 * rank + 2
        with autograd.record():
            part = gluon.loss.SoftmaxCrossEntropyLoss()(
                rnet(nd.array(rx[lo:hi])), nd.array(ry[lo:hi])).sum() / rb
        part.backward()
        trainer.step(1)
        total = part._data.detach().reshape(1).clone()
        torch.distributed.all_reduce(total)
    report("resnet50 dp", {"dp": n}, float(total[0]))

    # pipeline parallelism: pp x sp x tp, the stage-major schedule
    if n % 2 == 0:
        pp_axes = _dryrun_pp_axes(n)
        pp_mesh = parallel.make_mesh(pp_axes, device=device)
        pp_cfg = tf.TransformerConfig(
            vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
            max_len=32, pp_axis="pp", use_ring_attention=pp_axes["sp"] > 1,
            remat_layers=True)
        pp_params = tf.shard_params(
            tf.init_params(pp_cfg, seed=0, device=device), pp_cfg, pp_mesh)
        pp_tokens = np.random.RandomState(1).randint(
            0, pp_cfg.vocab_size, (max(4, 2 * pp_axes["dp"]),
                                   pp_cfg.max_len))
        _, _, pp_loss = tf.make_train_step(pp_cfg, pp_mesh, lr=1e-2)(
            pp_params, tf.init_momentum(pp_params), pp_tokens)
        report("pp", pp_axes, float(pp_loss))
    torch.distributed.barrier()
    if rank == 0:
        with open(out, "w") as f:
            _json.dump(losses, f)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n, device=None, timeout=600):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip``:
    spawn an ``n``-rank world (each rank a process running this module,
    joined through ``parallel.init_distributed`` over a FileStore) and
    run one step of each of JAX's three legs — the LM train step under
    dp/tp/sp/ep (JAX's axis factoring), the ResNet-50 dp step through the
    Gluon ``Trainer`` over ``dist_sync``, and the pp x sp x tp step. Each
    leg's loss must be finite; rank 0 prints ``... loss=... OK`` per leg.

    The world uses NCCL, one card a rank, and needs ``n`` cards, unless
    the caller asks for the CPU (``device="cpu"``): then gloo. Returns
    {leg: loss}."""
    import json as _json
    import subprocess
    import sys
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        resolve_device(device)
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                "dryrun_multichip(%d) needs %d cards, one a rank (this host "
                "has %d); pass device='cpu' for a gloo world on the host"
                % (n, n, torch.cuda.device_count()))
    work = tempfile.mkdtemp(prefix="dryrun_")
    try:
        store, out = os.path.join(work, "store"), os.path.join(work,
                                                               "out.json")
        env = dict(os.environ, MXNET_TPU_NUM_PROC=str(n))
        if cpu:
            env["CUDA_VISIBLE_DEVICES"] = ""
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.entry", "--dryrun-rank",
             str(n), store, out], env=dict(env, MXNET_TPU_PROC_ID=str(r)))
            for r in range(n)]
        deadline = time.time() + timeout
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if any(c != 0 for c in codes):
            raise RuntimeError("dryrun_multichip(%d): rank exit codes %s"
                               % (n, codes))
        with open(out) as f:
            return _json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------- recurrent LMs ---

# upstream example/gluon/word_language_model/train.py's defaults with
# --tied (WikiText-2's vocabulary), and example/rnn/bucketing/
# lstm_bucketing.py's (PTB's vocabulary)
WORD_LM = dict(vocab=33278, emsize=650, nhid=650, nlayers=2, dropout=0.5,
               lr=20.0, clip=0.25, bptt=35, batch_size=32)
BUCKETING_LM = dict(vocab=10000, num_embed=200, num_hidden=200,
                    num_layers=2, buckets=(10, 20, 30, 40, 50, 60),
                    batch_size=32, batches=24, lr=0.01, mom=0.0, wd=1e-5,
                    invalid_label=0, start_label=1)


def lm_tokens(n, vocab, seed=0, low=0):
    """``n`` token ids in [low, vocab) from ``RandomState(seed)``,
    log-uniform (a Zipf-like frequency profile, as words in text have):
    the stand-in for a corpus that the repository does not hold."""
    u = np.random.RandomState(seed).rand(n)
    span = vocab - low
    ids = np.floor(np.exp(u * np.log(span + 1.0))) - 1.0
    return (low + np.clip(ids, 0, span - 1)).astype(np.int64)


def word_lm_model(vocab, emsize, nhid, nlayers, dropout=0.5, prefix=None):
    """Upstream ``model.py``'s ``RNNModel`` with ``--tied``: Embedding
    (Uniform(0.1)), dropout, the fused LSTM (``dropout`` between its
    layers), dropout, and a Dense decoder that shares the embedding's
    weight (so ``nhid == emsize``)."""
    from . import gluon
    from .gluon import nn, rnn
    assert nhid == emsize, "tied weights need nhid == emsize (%d != %d)" % (
        nhid, emsize)

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(
                    vocab, emsize,
                    weight_initializer=initializer.Uniform(0.1))
                self.rnn = rnn.LSTM(nhid, nlayers, dropout=dropout,
                                    input_size=emsize)
                self.decoder = nn.Dense(vocab, in_units=nhid,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            decoded = self.decoder(output.reshape((-1, nhid)))
            return decoded, hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel(prefix=prefix)


class WordLM:
    """Upstream ``train.py``'s loop on ``ctx``, one bptt window a
    ``step``: the hidden state detached, a recorded forward and backward
    of ``SoftmaxCrossEntropyLoss`` over every token of the window, the
    summed gradients clipped by ``clip_global_norm`` at clip x bptt x
    batch, and ``trainer.step(bptt x batch)`` (SGD, no momentum, no
    weight decay): upstream's update of the per-token mean loss, clipped
    at ``clip``. (Stepping by the batch alone, as an older revision of
    the example did, makes each step bptt times larger: at lr 20 the loss
    then rises over the first steps.)"""

    def __init__(self, model, trainer, source, spec, ctx):
        from .gluon import loss as gloss
        self.model, self.trainer, self.source = model, trainer, source
        self.spec, self.ctx = spec, ctx
        self.loss = gloss.SoftmaxCrossEntropyLoss()
        self.params = list(model.collect_params().values())
        self.hidden = model.begin_state(func=nd.zeros,
                                        batch_size=spec["batch_size"],
                                        ctx=ctx)

    @property
    def windows(self):
        return (self.source.shape[0] - 1) // self.spec["bptt"]

    def batch(self, i):
        """(data (bptt, batch), target (bptt * batch,)) of window ``i``."""
        bptt = self.spec["bptt"]
        start = (i % self.windows) * bptt
        data = self.source[start:start + bptt]
        target = self.source[start + 1:start + 1 + bptt].reshape((-1,))
        return data, target

    def step(self, i):
        """One training step on window ``i``; returns the per-token loss
        (an NDArray on ``ctx``, not read back)."""
        from . import autograd
        from .gluon import utils as gutils
        spec = self.spec
        data, target = self.batch(i)
        self.hidden = [h.detach() for h in self.hidden]
        with autograd.record():
            output, self.hidden = self.model(data, self.hidden)
            L = self.loss(output, target)
            L.backward()
        grads = [p.grad(self.ctx) for p in self.params]
        gutils.clip_global_norm(
            grads, spec["clip"] * spec["bptt"] * spec["batch_size"])
        self.trainer.step(spec["bptt"] * spec["batch_size"])
        return L


def word_lm_setup(ctx=None, seed=0, hybridize=True, prefix="lm_", **spec):
    """The word LM of upstream ``example/gluon/word_language_model`` on
    ``ctx`` (the current context unless given), at ``WORD_LM``'s widths
    unless ``spec`` says otherwise: ``RNNModel`` initialized by
    ``Xavier()`` from ``ctx``'s generator, a ``Trainer("sgd",
    learning_rate=lr, momentum=0, wd=0)``, and a corpus of
    ``lm_tokens`` from ``seed``, batchified to (windows x bptt + 1,
    batch) on ``ctx``. Returns the ``WordLM``."""
    from . import gluon
    spec = dict(WORD_LM, **spec)
    ctx = ctx if ctx is not None else current_context()
    steps = spec.pop("windows", 20)
    model = word_lm_model(spec["vocab"], spec["emsize"], spec["nhid"],
                          spec["nlayers"], spec["dropout"], prefix=prefix)
    model.initialize(initializer.Xavier(), ctx=ctx)
    if hybridize:
        model.hybridize()
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": spec["lr"], "momentum": 0,
                             "wd": 0})
    b = spec["batch_size"]
    corpus = lm_tokens((steps * spec["bptt"] + 1) * b, spec["vocab"], seed)
    # upstream's batchify: (batch, n) then transposed, time-major
    source = nd.array(corpus.reshape(b, -1).T.astype(np.float32), ctx=ctx)
    return WordLM(model, trainer, source, spec, ctx)


def word_lm(steps=20, ctx=None, seed=0, hybridize=True, **spec):
    """``steps`` training steps of ``word_lm_setup``'s model, reading each
    step's mean token loss back as upstream's loop does. Returns
    (the ``WordLM``, the losses)."""
    run = word_lm_setup(ctx=ctx, seed=seed, hybridize=hybridize,
                        windows=steps, **spec)
    losses = [float(run.step(i).mean().asscalar()) for i in range(steps)]
    return run, losses


def bucketing_sentences(spec=BUCKETING_LM, seed=0):
    """``spec["batches"]`` batches' worth of sentences from
    ``RandomState(seed)``, spread evenly over the buckets (a sentence of
    bucket b is longer than the bucket below it and at most b tokens
    long, log-uniform ids in [start_label, vocab)): the stand-in for PTB,
    which the repository does not hold."""
    buckets = sorted(spec["buckets"])
    per_bucket = spec["batches"] // len(buckets) * spec["batch_size"]
    rs = np.random.RandomState(seed)
    lengths = [int(rs.randint(low + 1, b + 1))
               for low, b in zip([0] + buckets[:-1], buckets)
               for _ in range(per_bucket)]
    ids = lm_tokens(sum(lengths), spec["vocab"], seed + 1,
                    low=spec["start_label"])
    out, pos = [], 0
    for n in lengths:
        out.append([int(t) for t in ids[pos:pos + n]])
        pos += n
    return out


def bucketing_lm(ctx=None, seed=0, num_epoch=1, batch_end_callback=None,
                 arg_params=None, **spec):
    """Upstream ``example/rnn/bucketing/lstm_bucketing.py`` at
    ``BUCKETING_LM``'s values unless ``spec`` says otherwise: a
    ``SequentialRNNCell`` of ``num_layers`` ``rnn.LSTMCell``s unrolled per
    bucket by ``sym_gen``, ``BucketSentenceIter`` over
    ``bucketing_sentences(spec, seed)``, and ``BucketingModule.fit`` on
    ``ctx`` (the current context unless given) with SGD (lr, momentum,
    wd), ``Xavier(factor_type="in", magnitude=2.34)`` for what
    ``arg_params`` does not give, ``Perplexity(invalid_label)`` and the
    Speedometer. Returns (module, the cell stack, the iterator)."""
    from . import metric, rnn
    from . import symbol as sym
    spec = dict(BUCKETING_LM, **spec)
    ctx = ctx if ctx is not None else current_context()
    vocab, nh = spec["vocab"], spec["num_hidden"]
    stack = rnn.SequentialRNNCell()
    for i in range(spec["num_layers"]):
        stack.add(rnn.LSTMCell(num_hidden=nh, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=vocab,
                              output_dim=spec["num_embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, nh))
        pred = sym.FullyConnected(data=pred, num_hidden=vocab, name="pred")
        label = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)

    with ctx:
        train = rnn.BucketSentenceIter(
            bucketing_sentences(spec, seed), spec["batch_size"],
            buckets=list(spec["buckets"]),
            invalid_label=spec["invalid_label"])
        mod = module.BucketingModule(
            sym_gen=sym_gen, default_bucket_key=train.default_bucket_key,
            context=ctx)
        mod.fit(train_data=train,
                eval_metric=metric.Perplexity(spec["invalid_label"]),
                kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": spec["lr"],
                                  "momentum": spec["mom"],
                                  "wd": spec["wd"]},
                initializer=initializer.Xavier(factor_type="in",
                                               magnitude=2.34),
                arg_params=arg_params, allow_missing=arg_params is not None,
                num_epoch=num_epoch,
                batch_end_callback=[callback.Speedometer(
                    spec["batch_size"], 50, auto_reset=False)]
                + list(batch_end_callback or []))
    return mod, stack, train


def _main(argv=None):
    import argparse
    import json as _json
    import sys
    from .models import transformer as tf

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dryrun-rank"] and len(argv) == 4:
        _dryrun_rank(int(argv[1]), argv[2], argv[3])
        return 0
    ap = argparse.ArgumentParser(
        description="the port's elastic worker, one generation of a job "
                    "under python -m mxnet_tpu_torch.tools.elastic_launch")
    ap.add_argument("--elastic-worker", action="store_true", required=True)
    ap.add_argument("--ckpt-dir", default="./elastic_ckpt")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--gen-steps", type=int, default=2,
                    help="steps a shrunk generation runs before handing "
                         "back at a boundary")
    ap.add_argument("--lr", type=float, default=ELASTIC_LR)
    ap.add_argument("--config", default=None,
                    help="TransformerConfig fields as JSON (default: the "
                         "example's toy model)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--allow-partial", action="store_true")
    ap.add_argument("--keep-global-batch", action="store_true")
    ap.add_argument("--heartbeat-s", type=float, default=None)
    ap.add_argument("--miss", type=int, default=None)
    ap.add_argument("--keep-generations", type=int, default=None)
    ap.add_argument("--solo", action="store_true",
                    help="one card: rank 0 trains alone, other ranks exit "
                         "at once as absent peers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    fields = _json.loads(args.config) if args.config else \
        dict(ELASTIC_TOY_CFG)
    cfg = tf.TransformerConfig(dtype=getattr(torch, args.dtype), **fields)
    return elastic_worker(
        args.ckpt_dir, cfg, steps=args.steps, gen_steps=args.gen_steps,
        lr=args.lr, allow_partial=args.allow_partial,
        keep_global_batch=args.keep_global_batch,
        heartbeat_s=args.heartbeat_s, miss=args.miss,
        keep_generations=args.keep_generations,
        # the launcher's --chaos-spec reaches the worker as MXNET_CHAOS
        chaos_spec=os.environ.get("MXNET_CHAOS"), solo=args.solo,
        device=args.device)


if __name__ == "__main__":
    raise SystemExit(_main())
