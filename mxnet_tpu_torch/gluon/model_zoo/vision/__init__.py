"""Gluon model zoo for vision (port of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``).

The ResNet family is here, v1 and v2 at depths 18 to 152, with
``get_model(name)``. The other families of the JAX package (AlexNet,
DenseNet, Inception, MobileNet, SqueezeNet, VGG) wait for ROADMAP item
A9: ``get_model`` names the item for them. Pretrained weights are not
available (no model store); construct, initialize and train.
"""

from ....base import MXNetError
from .resnet import *
from .resnet import resnet_spec

# the JAX package's other model-zoo names (ROADMAP item A9)
_QUEUED_MODELS = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Return a model by name, e.g. get_model('resnet50_v1', classes=10)."""
    models = {"resnet%d_v%d" % (depth, version):
              globals()["resnet%d_v%d" % (depth, version)]
              for depth in resnet_spec for version in (1, 2)}
    name = name.lower()
    if name in _QUEUED_MODELS:
        raise MXNetError(
            "model %s is in mxnet_tpu/gluon/model_zoo/vision/, which the "
            "PyTorch port has not ported yet (ROADMAP item A9)" % name)
    if name not in models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(models))))
    return models[name](**kwargs)
