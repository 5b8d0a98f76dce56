"""The PyTorch port stands alone: ``mxnet_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package
``mxnet_tpu`` (not even its modules that do not import JAX), and the
smoke script refuses to run without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _imported_modules(path):
    """Absolute module names imported anywhere in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def _run(code_or_args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + code_or_args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax(tmp_path):
    """Importing the package and its serving path, running one train
    step of its training path on the CPU (rope, MoE, remat through the
    flash autograd function), and importing Gluon, Symbol, the model zoo
    and ``entry`` and taking one hybridized SGD step of ResNet-18
    (thumbnail) on the CPU, then one ``Trainer`` step with a Gluon loss,
    an LR scheduler and ``gluon.utils``, and the ``LeakyReLU``,
    ``Deconvolution``, ``CTCLoss`` and ``RNN`` ops, leaves jax and
    mxnet_tpu out of sys.modules, and needs no nvcc."""
    code = ("import sys, mxnet_tpu_torch\n"
            "from mxnet_tpu_torch.models import serving, convert\n"
            "from mxnet_tpu_torch.models import transformer as tf\n"
            "cfg = tf.TransformerConfig(rope=True, n_experts=2, max_len=8, "
            "remat_layers=True, use_flash_kernel=True)\n"
            "p = tf.init_params(cfg, device='cpu')\n"
            "tf.make_train_step(cfg)(p, tf.init_momentum(p), [list(range(8))])\n"
            "from mxnet_tpu_torch import autograd, entry, gluon, nd, sym\n"
            "from mxnet_tpu_torch.gluon.model_zoo import vision\n"
            "with mxnet_tpu_torch.cpu():\n"
            "    net = vision.resnet18_v1(thumbnail=True, classes=10)\n"
            "    net.initialize(mxnet_tpu_torch.init.Xavier())\n"
            "    net.hybridize()\n"
            "    x, y = nd.ones((2, 3, 32, 32)), nd.array([1, 2])\n"
            "    with autograd.record():\n"
            "        loss = nd.softmax_cross_entropy(net(x), y)\n"
            "    loss.backward()\n"
            "    for q in net.collect_params().values():\n"
            "        if q.grad_req != 'null':\n"
            "            q.set_data(q.data() - 0.1 * q.grad())\n"
            "    assert sym.load_json(net._cached_graph[1].tojson())\n"
            "    sched = mxnet_tpu_torch.lr_scheduler.FactorScheduler(2)\n"
            "    trainer = gluon.Trainer(net.collect_params(), 'sgd', "
            "{'momentum': 0.9, 'lr_scheduler': sched})\n"
            "    with autograd.record():\n"
            "        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)\n"
            "    loss.backward()\n"
            "    gluon.utils.clip_global_norm(\n"
            "        [q.grad() for q in net.collect_params().values()\n"
            "         if q.grad_req != 'null'], 1.0)\n"
            "    trainer.step(2)\n"
            "    z = nd.LeakyReLU(nd.ones((1, 2, 3, 3)), act_type='elu')\n"
            "    z = nd.Deconvolution(z, nd.ones((2, 1, 2, 2)), "
            "kernel=(2, 2), num_filter=1)\n"
            "    nd.CTCLoss(nd.ones((4, 1, 3)), nd.array([[1, 2]]))\n"
            "    nd.RNN(nd.ones((3, 1, 2)), nd.ones((36,)), state_size=2, "
            "mode='gru')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\n"
            "print('BAD', bad)\n" % (FORBIDDEN,))
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_data_and_io_load_no_jax(tmp_path):
    """Importing the data and IO modules (``recordio`` with ``_native``,
    ``io``, ``image``, ``ops.image_ops``, ``gluon.data`` with ``vision``,
    ``contrib.io``) and driving them on the CPU — records written and read
    back through the native scanner, an ``ImageRecordIter`` batch, a
    serial ``DataLoader`` through ``ToTensor`` and ``Normalize``, an image
    op — leaves jax and mxnet_tpu out of sys.modules."""
    code = ("import sys, io, numpy as np, mxnet_tpu_torch as mt\n"
            "from mxnet_tpu_torch import _native, recordio, image, contrib\n"
            "from mxnet_tpu_torch import io as mio\n"
            "from mxnet_tpu_torch.ops import image_ops\n"
            "from mxnet_tpu_torch.gluon import data\n"
            "from mxnet_tpu_torch.gluon.data.vision import transforms as T\n"
            "w = recordio.MXIndexedRecordIO('a.idx', 'a.rec', 'w')\n"
            "for i in range(4):\n"
            "    b = io.BytesIO()\n"
            "    np.save(b, np.full((10, 10, 3), i, np.uint8))\n"
            "    w.write_idx(i, recordio.pack((0, float(i), i, 0), "
            "b.getvalue()))\n"
            "w.close()\n"
            "with mt.cpu():\n"
            "    it = mio.ImageRecordIter('a.rec', (3, 8, 8), 2, "
            "path_imgidx='a.idx', rand_crop=True)\n"
            "    assert it.next().data[0].shape == (2, 3, 8, 8)\n"
            "    assert _native.recordio_lib() is not None\n"
            "    ds = data.ArrayDataset(np.zeros((4, 6, 6, 3), np.uint8), "
            "np.arange(4)).transform_first(T.Compose([T.ToTensor(), "
            "T.Normalize(0.5, 0.2)]))\n"
            "    assert len(list(data.DataLoader(ds, batch_size=2))) == 2\n"
            "    mt.nd.image.resize(mt.nd.zeros((6, 6, 3)), size=4)\n"
            "    assert contrib.io.DataLoaderIter\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\n"
            "print('BAD', bad)\n" % (FORBIDDEN,))
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_chip_smoke_refuses_without_a_gpu():
    """With no CUDA device the smoke script exits nonzero and prints no
    result line."""
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
