"""GoogLeNet (reference: mxnet_tpu/models/googlenet.py,
after example/image-classification/symbols/googlenet.py)."""
from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                name=None, suffix=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad,
                           name=f"conv_{name}{suffix}")
    act = sym.Activation(data=conv, act_type="relu",
                         name=f"relu_{name}{suffix}")
    return act


def InceptionFactory(data, num_1x1, num_3x3red, num_3x3, num_d5x5red,
                     num_d5x5, pool, proj, name):
    c1x1 = ConvFactory(data=data, num_filter=num_1x1, kernel=(1, 1),
                       name=f"{name}_1x1")
    c3x3r = ConvFactory(data=data, num_filter=num_3x3red, kernel=(1, 1),
                        name=f"{name}_3x3", suffix="_reduce")
    c3x3 = ConvFactory(data=c3x3r, num_filter=num_3x3, kernel=(3, 3),
                       pad=(1, 1), name=f"{name}_3x3")
    cd5x5r = ConvFactory(data=data, num_filter=num_d5x5red, kernel=(1, 1),
                         name=f"{name}_5x5", suffix="_reduce")
    cd5x5 = ConvFactory(data=cd5x5r, num_filter=num_d5x5, kernel=(5, 5),
                        pad=(2, 2), name=f"{name}_5x5")
    pooling = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                          pool_type=pool, name=f"{pool}_pool_{name}_pool")
    cproj = ConvFactory(data=pooling, num_filter=proj, kernel=(1, 1),
                        name=f"{name}_proj")
    return sym.Concat(c1x1, c3x3, cd5x5, cproj,
                      name=f"ch_concat_{name}_chconcat")


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1 = ConvFactory(data, 64, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                        name="conv1")
    pool1 = sym.Pooling(conv1, kernel=(3, 3), stride=(2, 2), pool_type="max")
    conv2 = ConvFactory(pool1, 64, kernel=(1, 1), stride=(1, 1), name="conv2")
    conv3 = ConvFactory(conv2, 192, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        name="conv3")
    pool3 = sym.Pooling(conv3, kernel=(3, 3), stride=(2, 2), pool_type="max")
    in3a = InceptionFactory(pool3, 64, 96, 128, 16, 32, "max", 32, name="in3a")
    in3b = InceptionFactory(in3a, 128, 128, 192, 32, 96, "max", 64,
                            name="in3b")
    pool4 = sym.Pooling(in3b, kernel=(3, 3), stride=(2, 2), pool_type="max")
    in4a = InceptionFactory(pool4, 192, 96, 208, 16, 48, "max", 64,
                            name="in4a")
    in4b = InceptionFactory(in4a, 160, 112, 224, 24, 64, "max", 64,
                            name="in4b")
    in4c = InceptionFactory(in4b, 128, 128, 256, 24, 64, "max", 64,
                            name="in4c")
    in4d = InceptionFactory(in4c, 112, 144, 288, 32, 64, "max", 64,
                            name="in4d")
    in4e = InceptionFactory(in4d, 256, 160, 320, 32, 128, "max", 128,
                            name="in4e")
    pool5 = sym.Pooling(in4e, kernel=(3, 3), stride=(2, 2), pool_type="max")
    in5a = InceptionFactory(pool5, 256, 160, 320, 32, 128, "max", 128,
                            name="in5a")
    in5b = InceptionFactory(in5a, 384, 192, 384, 48, 128, "max", 128,
                            name="in5b")
    pool6 = sym.Pooling(in5b, kernel=(7, 7), stride=(1, 1), global_pool=True,
                        pool_type="avg")
    flatten = sym.Flatten(data=pool6)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc1, label=sym.Variable("softmax_label"),
                             name="softmax")
