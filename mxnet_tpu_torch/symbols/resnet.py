"""Symbolic ResNet factory: the port's copy of
``examples/image_classification/symbols/resnet.py`` (parity target:
example/image-classification/symbols/resnet.py, the bottleneck and basic
residual units and the function stacking the stages), built with the port's
``symbol``. The same arguments give the same argument names and
inferred shapes as the example's.
"""

from .. import symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                no_bias=True, name=name + "_conv3")
        shortcut = data if dim_match else \
            sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                            stride=stride, no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            pad=(1, 1), no_bias=True, name=name + "_conv2")
    shortcut = data if dim_match else \
        sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                        stride=stride, no_bias=True, name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9):
    data = sym.Variable("data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    height = image_shape[1]
    if height <= 32:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             "stage%d_unit1" % (i + 1), bottle_neck, bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 "stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck, bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


_CONFIGS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_symbol(num_classes, num_layers=50, image_shape=(3, 224, 224),
               **kwargs):
    if num_layers not in _CONFIGS:
        raise ValueError("no unit config for resnet-%d" % num_layers)
    units, bottle_neck = _CONFIGS[num_layers]
    filters = [64, 256, 512, 1024, 2048] if bottle_neck \
        else [64, 64, 128, 256, 512]
    return resnet(units, 4, filters, num_classes, image_shape, bottle_neck)
