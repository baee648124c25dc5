"""Inception-BN (reference: mxnet_tpu/models/inception_bn.py,
after example/image-classification/symbols/inception-bn.py)."""
from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                name=None, suffix=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name=f"conv_{name}{suffix}")
    bn = sym.BatchNorm(data=conv, fix_gamma=False, momentum=0.9,
                       name=f"bn_{name}{suffix}")
    act = sym.Activation(data=bn, act_type="relu", name=f"relu_{name}{suffix}")
    return act


def InceptionFactoryA(data, num_1x1, num_3x3red, num_3x3, num_d3x3red, num_d3x3,
                      pool, proj, name):
    # 1x1
    c1x1 = ConvFactory(data=data, num_filter=num_1x1, kernel=(1, 1),
                       name=f"{name}_1x1")
    # 3x3 reduce + 3x3
    c3x3r = ConvFactory(data=data, num_filter=num_3x3red, kernel=(1, 1),
                        name=f"{name}_3x3", suffix="_reduce")
    c3x3 = ConvFactory(data=c3x3r, num_filter=num_3x3, kernel=(3, 3),
                       pad=(1, 1), name=f"{name}_3x3")
    # double 3x3 reduce + double 3x3
    cd3x3r = ConvFactory(data=data, num_filter=num_d3x3red, kernel=(1, 1),
                         name=f"{name}_double_3x3", suffix="_reduce")
    cd3x3 = ConvFactory(data=cd3x3r, num_filter=num_d3x3, kernel=(3, 3),
                        pad=(1, 1), name=f"{name}_double_3x3_0")
    cd3x3 = ConvFactory(data=cd3x3, num_filter=num_d3x3, kernel=(3, 3),
                        pad=(1, 1), name=f"{name}_double_3x3_1")
    # pool + proj
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool, name=f"{pool}_pool_{name}_pool")
    cproj = ConvFactory(data=pooling, num_filter=proj, kernel=(1, 1),
                        name=f"{name}_proj")
    concat = sym.Concat(c1x1, c3x3, cd3x3, cproj, name=f"ch_concat_{name}_chconcat")
    return concat


def InceptionFactoryB(data, num_3x3red, num_3x3, num_d3x3red, num_d3x3, name):
    c3x3r = ConvFactory(data=data, num_filter=num_3x3red, kernel=(1, 1),
                        name=f"{name}_3x3", suffix="_reduce")
    c3x3 = ConvFactory(data=c3x3r, num_filter=num_3x3, kernel=(3, 3),
                       pad=(1, 1), stride=(2, 2), name=f"{name}_3x3")
    cd3x3r = ConvFactory(data=data, num_filter=num_d3x3red, kernel=(1, 1),
                         name=f"{name}_double_3x3", suffix="_reduce")
    cd3x3 = ConvFactory(data=cd3x3r, num_filter=num_d3x3, kernel=(3, 3),
                        pad=(1, 1), name=f"{name}_double_3x3_0")
    cd3x3 = ConvFactory(data=cd3x3, num_filter=num_d3x3, kernel=(3, 3),
                        pad=(1, 1), stride=(2, 2), name=f"{name}_double_3x3_1")
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name=f"max_pool_{name}_pool")
    concat = sym.Concat(c3x3, cd3x3, pooling, name=f"ch_concat_{name}_chconcat")
    return concat


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable(name="data")
    # stage 1
    conv1 = ConvFactory(data=data, num_filter=64, kernel=(7, 7), stride=(2, 2),
                        pad=(3, 3), name="conv1")
    pool1 = sym.Pooling(data=conv1, kernel=(3, 3), stride=(2, 2),
                        pool_type="max", name="pool_1")
    # stage 2
    conv2red = ConvFactory(data=pool1, num_filter=64, kernel=(1, 1),
                           name="conv2red")
    conv2 = ConvFactory(data=conv2red, num_filter=192, kernel=(3, 3),
                        pad=(1, 1), name="conv2")
    pool2 = sym.Pooling(data=conv2, kernel=(3, 3), stride=(2, 2),
                        pool_type="max", name="pool_2")
    # stage 3
    in3a = InceptionFactoryA(pool2, 64, 64, 64, 64, 96, "avg", 32, "3a")
    in3b = InceptionFactoryA(in3a, 64, 64, 96, 64, 96, "avg", 64, "3b")
    in3c = InceptionFactoryB(in3b, 128, 160, 64, 96, "3c")
    # stage 4
    in4a = InceptionFactoryA(in3c, 224, 64, 96, 96, 128, "avg", 128, "4a")
    in4b = InceptionFactoryA(in4a, 192, 96, 128, 96, 128, "avg", 128, "4b")
    in4c = InceptionFactoryA(in4b, 160, 128, 160, 128, 160, "avg", 128, "4c")
    in4d = InceptionFactoryA(in4c, 96, 128, 192, 160, 192, "avg", 128, "4d")
    in4e = InceptionFactoryB(in4d, 128, 192, 192, 256, "4e")
    # stage 5
    in5a = InceptionFactoryA(in4e, 352, 192, 320, 160, 224, "avg", 128, "5a")
    in5b = InceptionFactoryA(in5a, 352, 192, 320, 192, 224, "max", 128, "5b")
    # global avg pooling
    avg = sym.Pooling(data=in5b, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                      global_pool=True, name="global_pool")
    flatten = sym.Flatten(data=avg, name="flatten")
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, label=sym.Variable("softmax_label"),
                             name="softmax")
