"""The port's entry points for ResNet-50 v1, the JAX package's flagship:
``entry()``, the counterpart of ``__graft_entry__.entry()``, and
``build_train_step``, that of ``bench.py``'s ``build_train_step`` in its
default fold-cast layout.

Both trace the Gluon model-zoo net through ``utils.functionalize_block``
and run its graph function with torch ops (cuDNN and cuBLAS on the card,
in MXNet's NCHW layout). They run on the current context, ``gpu(0)``
unless the caller says ``with cpu():`` or passes ``ctx``. Parameters are
drawn by ``initializer.Xavier`` from the device's generator
(``random.generator``); the JAX package's can be copied into the returned
tensors by name (``models.convert.graph_params_from_numpy``).
"""

import torch

from . import initializer
from . import ndarray as nd
from .context import current_context
from .gluon.model_zoo import vision
from .utils import functionalize_block

__all__ = ["entry", "build_train_step"]

MOMENTUM = 0.9
SEED = 0            # the example input's generator (entry)
CLASSES = 1000


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
