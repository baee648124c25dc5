"""ResNet (reference: mxnet_tpu/models/resnet.py, after
example/image-classification/symbols/resnet.py).

Pre-activation residual units (BN-ReLU-Conv), bottlenecks from depth 50, the
same argument and aux names as the reference, NCHW or NHWC. ResNet-50 is
the model of the repo's first baseline metric.
"""
from .. import symbol as sym
from ..base import MXNetError


def _bn(data, name, bn_ax, bn_mom, fix_gamma=False):
    return sym.BatchNorm(data=data, axis=bn_ax, fix_gamma=fix_gamma,
                         eps=2e-5, momentum=bn_mom, name=name)


def _conv(data, name, layout, num_filter, kernel, stride, pad):
    return sym.Convolution(data=data, layout=layout, num_filter=num_filter,
                           kernel=kernel, stride=stride, pad=pad,
                           no_bias=True, name=name)


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, workspace=256, memonger=False, layout="NCHW"):
    """One unit: BN-ReLU-Conv three times (1x1, 3x3 with ``stride``, 1x1 to
    ``num_filter``) with a bottleneck of ``num_filter // 4``, else twice
    (3x3, 3x3); the shortcut is the input when ``dim_match``, else a 1x1
    convolution of the first activation. ``workspace`` and ``memonger`` are
    accepted and unused, as in the reference."""
    bn_ax = 3 if layout == "NHWC" else 1
    act1 = sym.Activation(data=_bn(data, name + "_bn1", bn_ax, bn_mom),
                          act_type="relu", name=name + "_relu1")
    if bottle_neck:
        convs = [(num_filter // 4, (1, 1), (1, 1), (0, 0)),
                 (num_filter // 4, (3, 3), stride, (1, 1)),
                 (num_filter, (1, 1), (1, 1), (0, 0))]
    else:
        convs = [(num_filter, (3, 3), stride, (1, 1)),
                 (num_filter, (3, 3), (1, 1), (1, 1))]
    body = act1
    for i, (nf, kernel, st, pad) in enumerate(convs, 1):
        if i > 1:
            body = sym.Activation(
                data=_bn(body, f"{name}_bn{i}", bn_ax, bn_mom),
                act_type="relu", name=f"{name}_relu{i}")
        body = _conv(body, f"{name}_conv{i}", layout, nf, kernel, st, pad)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv(act1, name + "_sc", layout, num_filter, (1, 1),
                         stride, (0, 0))
    return body + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, workspace=256, memonger=False,
           layout="NCHW", conv0_space_to_depth=False):
    """The network: a BatchNorm of the data (``fix_gamma``), a stem (3x3 at
    <= 32 px; else 7x7 stride 2, BN, ReLU, 3x3 max pool stride 2), the
    stages of residual units (stride 2 from the second stage), BN, ReLU, a
    global average pool, FullyConnected and SoftmaxOutput. The reference's
    ``conv0_space_to_depth`` (an NHWC stem shaped for the TPU's matrix
    unit) is not ported."""
    if conv0_space_to_depth:
        raise MXNetError("resnet: conv0_space_to_depth is not ported")
    bn_ax = 3 if layout == "NHWC" else 1
    assert len(units) == num_stages
    data = _bn(sym.Variable(name="data"), "bn_data", bn_ax, bn_mom,
               fix_gamma=True)
    _, height, _ = image_shape
    if height <= 32:  # cifar-style stem
        body = _conv(data, "conv0", layout, filter_list[0], (3, 3), (1, 1),
                     (1, 1))
    else:  # imagenet stem
        body = _conv(data, "conv0", layout, filter_list[0], (7, 7), (2, 2),
                     (3, 3))
        body = sym.Activation(data=_bn(body, "bn0", bn_ax, bn_mom),
                              act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max", layout=layout)
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name=f"stage{i + 1}_unit1",
                             bottle_neck=bottle_neck, bn_mom=bn_mom,
                             layout=layout)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i + 1}_unit{j + 2}",
                                 bottle_neck=bottle_neck, bn_mom=bn_mom,
                                 layout=layout)
    relu1 = sym.Activation(data=_bn(body, "bn1", bn_ax, bn_mom),
                           act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1", layout=layout)
    fc1 = sym.FullyConnected(data=sym.Flatten(data=pool1),
                             num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, label=sym.Variable("softmax_label"),
                             name="softmax")


_UNITS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
          101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
          269: [3, 30, 48, 8]}


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               conv_workspace=256, layout="NCHW", **kwargs):
    """ResNet by depth: 3 stages of (num_layers - 2) / 6 basic units (or /9
    bottleneck units from depth 164) at <= 32 px when the depth fits, else
    the 4 ImageNet stages of ``_UNITS`` (bottlenecks from depth 50)."""
    if isinstance(image_shape, str):
        image_shape = [int(x) for x in image_shape.split(",")]
    height = image_shape[1]
    cifar_depth = (num_layers - 2) % 9 == 0 and num_layers >= 164 \
        or (num_layers - 2) % 6 == 0 and num_layers < 164
    if height <= 32 and cifar_depth:
        if num_layers >= 164:
            per_unit, filter_list = (num_layers - 2) // 9, [16, 64, 128, 256]
        else:
            per_unit, filter_list = (num_layers - 2) // 6, [16, 16, 32, 64]
        units, num_stages = [per_unit] * 3, 3
        bottle_neck = num_layers >= 164
    else:
        if num_layers not in _UNITS:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units, num_stages = _UNITS[num_layers], 4
        bottle_neck = num_layers >= 50
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
            else [64, 64, 128, 256, 512]
    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, workspace=conv_workspace,
                  layout=layout,
                  conv0_space_to_depth=kwargs.get("conv0_space_to_depth",
                                                  False))
