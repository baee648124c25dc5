"""Inception-ResNet-v2 (reference: mxnet_tpu/models/inception_resnet_v2.py,
after example/image-classification/symbols/inception-resnet-v2.py; architecture:
Szegedy et al., "Inception-v4, Inception-ResNet and the Impact of Residual
Connections on Learning", arXiv:1602.07261).

Structure: stem -> 5x Inception-ResNet-A (35x35) -> Reduction-A ->
10x Inception-ResNet-B (17x17) -> Reduction-B -> 5x Inception-ResNet-C
(8x8) -> global pool -> dropout -> softmax. Residual branch outputs are
scaled (0.17/0.10/0.20) before the add, per the paper's stabilization.
"""
from .. import symbol as sym


def Conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
         name=None, with_act=True):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=True,
                           name=f"{name}_conv2d")
    bn = sym.BatchNorm(data=conv, eps=2e-5, fix_gamma=False,
                       name=f"{name}_batchnorm")
    if not with_act:
        return bn
    return sym.Activation(data=bn, act_type="relu", name=f"{name}_relu")


def stem(data):
    c = Conv(data, 32, kernel=(3, 3), stride=(2, 2), name="stem_conv1")
    c = Conv(c, 32, kernel=(3, 3), name="stem_conv2")
    c = Conv(c, 64, kernel=(3, 3), pad=(1, 1), name="stem_conv3")
    c = sym.Pooling(data=c, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="stem_pool1")
    c = Conv(c, 80, name="stem_conv4")
    c = Conv(c, 192, kernel=(3, 3), name="stem_conv5")
    c = sym.Pooling(data=c, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="stem_pool2")
    # 35x35 mixed stem tail (Inception-A-style)
    t0 = Conv(c, 96, name="stem_mix_conv")
    t1 = Conv(c, 48, name="stem_mix_tower1_conv1")
    t1 = Conv(t1, 64, kernel=(5, 5), pad=(2, 2), name="stem_mix_tower1_conv2")
    t2 = Conv(c, 64, name="stem_mix_tower2_conv1")
    t2 = Conv(t2, 96, kernel=(3, 3), pad=(1, 1), name="stem_mix_tower2_conv2")
    t2 = Conv(t2, 96, kernel=(3, 3), pad=(1, 1), name="stem_mix_tower2_conv3")
    t3 = sym.Pooling(data=c, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="stem_mix_pool")
    t3 = Conv(t3, 64, name="stem_mix_tower3_conv")
    return sym.Concat(t0, t1, t2, t3, name="stem_mix_concat")  # 320 ch


def block35(net, scale, name):
    """Inception-ResNet-A: 35x35, residual over (1x1, 3x3, double-3x3)."""
    t0 = Conv(net, 32, name=f"{name}_b0_conv")
    t1 = Conv(net, 32, name=f"{name}_b1_conv1")
    t1 = Conv(t1, 32, kernel=(3, 3), pad=(1, 1), name=f"{name}_b1_conv2")
    t2 = Conv(net, 32, name=f"{name}_b2_conv1")
    t2 = Conv(t2, 48, kernel=(3, 3), pad=(1, 1), name=f"{name}_b2_conv2")
    t2 = Conv(t2, 64, kernel=(3, 3), pad=(1, 1), name=f"{name}_b2_conv3")
    mixed = sym.Concat(t0, t1, t2, name=f"{name}_concat")
    up = Conv(mixed, 320, name=f"{name}_up", with_act=False)
    return sym.Activation(net + up * scale, act_type="relu",
                          name=f"{name}_out")


def reduction_a(net):
    t0 = Conv(net, 384, kernel=(3, 3), stride=(2, 2), name="reda_b0_conv")
    t1 = Conv(net, 256, name="reda_b1_conv1")
    t1 = Conv(t1, 256, kernel=(3, 3), pad=(1, 1), name="reda_b1_conv2")
    t1 = Conv(t1, 384, kernel=(3, 3), stride=(2, 2), name="reda_b1_conv3")
    t2 = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="reda_pool")
    return sym.Concat(t0, t1, t2, name="reda_concat")  # 1088 ch


def block17(net, scale, name):
    """Inception-ResNet-B: 17x17, residual over (1x1, 1x7->7x1)."""
    t0 = Conv(net, 192, name=f"{name}_b0_conv")
    t1 = Conv(net, 128, name=f"{name}_b1_conv1")
    t1 = Conv(t1, 160, kernel=(1, 7), pad=(0, 3), name=f"{name}_b1_conv2")
    t1 = Conv(t1, 192, kernel=(7, 1), pad=(3, 0), name=f"{name}_b1_conv3")
    mixed = sym.Concat(t0, t1, name=f"{name}_concat")
    up = Conv(mixed, 1088, name=f"{name}_up", with_act=False)
    return sym.Activation(net + up * scale, act_type="relu",
                          name=f"{name}_out")


def reduction_b(net):
    t0 = Conv(net, 256, name="redb_b0_conv1")
    t0 = Conv(t0, 384, kernel=(3, 3), stride=(2, 2), name="redb_b0_conv2")
    t1 = Conv(net, 256, name="redb_b1_conv1")
    t1 = Conv(t1, 288, kernel=(3, 3), stride=(2, 2), name="redb_b1_conv2")
    t2 = Conv(net, 256, name="redb_b2_conv1")
    t2 = Conv(t2, 288, kernel=(3, 3), pad=(1, 1), name="redb_b2_conv2")
    t2 = Conv(t2, 320, kernel=(3, 3), stride=(2, 2), name="redb_b2_conv3")
    t3 = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redb_pool")
    return sym.Concat(t0, t1, t2, t3, name="redb_concat")  # 2080 ch


def block8(net, scale, name):
    """Inception-ResNet-C: 8x8, residual over (1x1, 1x3->3x1)."""
    t0 = Conv(net, 192, name=f"{name}_b0_conv")
    t1 = Conv(net, 192, name=f"{name}_b1_conv1")
    t1 = Conv(t1, 224, kernel=(1, 3), pad=(0, 1), name=f"{name}_b1_conv2")
    t1 = Conv(t1, 256, kernel=(3, 1), pad=(1, 0), name=f"{name}_b1_conv3")
    mixed = sym.Concat(t0, t1, name=f"{name}_concat")
    up = Conv(mixed, 2080, name=f"{name}_up", with_act=False)
    return sym.Activation(net + up * scale, act_type="relu",
                          name=f"{name}_out")


def get_symbol(num_classes=1000, dropout=0.2, **kwargs):
    data = sym.Variable(name="data")
    net = stem(data)
    for i in range(5):
        net = block35(net, 0.17, f"irA{i}")
    net = reduction_a(net)
    for i in range(10):
        net = block17(net, 0.10, f"irB{i}")
    net = reduction_b(net)
    for i in range(5):
        net = block8(net, 0.20, f"irC{i}")
    net = Conv(net, 1536, name="final_conv")
    net = sym.Pooling(data=net, global_pool=True, kernel=(8, 8),
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    if dropout:
        net = sym.Dropout(data=net, p=dropout, name="dropout")
    fc = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
