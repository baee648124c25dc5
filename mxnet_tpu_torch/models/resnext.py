"""ResNeXt (reference: mxnet_tpu/models/resnext.py,
after example/image-classification/symbols/resnext.py)."""
from .. import symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name, num_group=32,
                  bn_mom=0.9):
    conv1 = sym.Convolution(data=data, num_filter=num_filter // 2,
                            kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                            no_bias=True, name=name + "_conv1")
    bn1 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    conv2 = sym.Convolution(data=act1, num_filter=num_filter // 2,
                            num_group=num_group, kernel=(3, 3), stride=stride,
                            pad=(1, 1), no_bias=True, name=name + "_conv2")
    bn2 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn2")
    act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
    conv3 = sym.Convolution(data=act2, num_filter=num_filter, kernel=(1, 1),
                            stride=(1, 1), pad=(0, 0), no_bias=True,
                            name=name + "_conv3")
    bn3 = sym.BatchNorm(data=conv3, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn3")
    if dim_match:
        shortcut = data
    else:
        shortcut_conv = sym.Convolution(data=data, num_filter=num_filter,
                                        kernel=(1, 1), stride=stride,
                                        no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(data=shortcut_conv, fix_gamma=False,
                                 eps=2e-5, momentum=bn_mom,
                                 name=name + "_sc_bn")
    return sym.Activation(data=bn3 + shortcut, act_type="relu",
                          name=name + "_relu")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape="3,224,224", **kwargs):
    if isinstance(image_shape, str):
        image_shape = [int(x) for x in image_shape.split(",")]
    unit_map = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    if num_layers not in unit_map:
        raise ValueError(f"no experiments done on num_layers {num_layers}")
    units = unit_map[num_layers]
    filter_list = [64, 256, 512, 1024, 2048]

    data = sym.Variable(name="data")
    body = sym.Convolution(data=data, num_filter=filter_list[0],
                           kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                           no_bias=True, name="conv0")
    body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn0")
    body = sym.Activation(data=body, act_type="relu", name="relu0")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for i in range(4):
        body = residual_unit(body, filter_list[i + 1],
                             (1, 1) if i == 0 else (2, 2), False,
                             name=f"stage{i+1}_unit1", num_group=num_group)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i+1}_unit{j+2}",
                                 num_group=num_group)
    pool1 = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, label=sym.Variable("softmax_label"),
                             name="softmax")
