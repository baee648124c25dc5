"""SSD network assembled from framework ops (reference: example/ssd/
symbol.py, after symbol_vgg16_ssd_300.py and legacy_train.py): a compact
conv body over 64x64 inputs with two anchor scales, the whole multibox
pipeline (prior, target, softmax and smooth-L1 losses, detection). It
emits the reference's graph, node for node."""
import mxnet_tpu_torch as mx


def conv_act(data, name, num_filter, stride=1):
    c = mx.sym.Convolution(data=data, num_filter=num_filter, kernel=(3, 3),
                           stride=(stride, stride), pad=(1, 1), name=name)
    return mx.sym.Activation(data=c, act_type="relu", name=name + "_relu")


def multibox_layer(body, name, num_classes, sizes, ratios):
    """Per-scale loc and cls heads and priors (reference: common.py
    multibox_layer)."""
    num_anchors = len(sizes) + len(ratios) - 1
    loc = mx.sym.Convolution(data=body, num_filter=num_anchors * 4,
                             kernel=(3, 3), pad=(1, 1), name=name + "_loc")
    # (B, A*4, H, W) -> (B, H*W*A*4)
    loc = mx.sym.Flatten(data=mx.sym.transpose(loc, axes=(0, 2, 3, 1)))
    cls = mx.sym.Convolution(data=body,
                             num_filter=num_anchors * (num_classes + 1),
                             kernel=(3, 3), pad=(1, 1), name=name + "_cls")
    # (B, A*(C+1), H, W) -> (B, H*W*A, C+1)
    cls = mx.sym.Reshape(
        data=mx.sym.transpose(cls, axes=(0, 2, 3, 1)),
        shape=(0, -1, num_classes + 1))
    anchors = mx.sym.MultiBoxPrior(body, sizes=sizes, ratios=ratios,
                                   name=name + "_prior")
    return loc, cls, anchors


def get_ssd_body(data, num_classes):
    """Backbone and two detection scales -> (loc_preds, cls_preds,
    anchors)."""
    b = conv_act(data, "conv1", 16)
    b = mx.sym.Pooling(data=b, kernel=(2, 2), stride=(2, 2), pool_type="max")
    b = conv_act(b, "conv2", 32)
    b = mx.sym.Pooling(data=b, kernel=(2, 2), stride=(2, 2), pool_type="max")
    scale1 = conv_act(b, "conv3", 32)                       # 16x16
    scale2 = conv_act(scale1, "conv4", 32, stride=2)        # 8x8

    loc1, cls1, anc1 = multibox_layer(scale1, "s1", num_classes,
                                      sizes=(0.2, 0.3), ratios=(1.0, 2.0, 0.5))
    loc2, cls2, anc2 = multibox_layer(scale2, "s2", num_classes,
                                      sizes=(0.45, 0.6), ratios=(1.0, 2.0, 0.5))
    loc_preds = mx.sym.Concat(loc1, loc2, dim=1)
    cls_preds = mx.sym.transpose(mx.sym.Concat(cls1, cls2, dim=1),
                                 axes=(0, 2, 1))            # (B, C+1, A)
    anchors = mx.sym.Concat(anc1, anc2, dim=1)              # (1, A, 4)
    return loc_preds, cls_preds, anchors


def get_ssd_train(num_classes=2):
    """Training symbol: MultiBoxTarget, then a softmax cls loss and a
    smooth-L1 loc loss normalised by the match count (reference:
    symbol_vgg16_ssd_300.py:160-186)."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("label")
    loc_preds, cls_preds, anchors = get_ssd_body(data, num_classes)

    loc_target, loc_mask, cls_target = mx.sym.MultiBoxTarget(
        anchor=anchors, label=label, cls_pred=cls_preds,
        overlap_threshold=0.5, negative_mining_ratio=3, name="mbt")
    cls_prob = mx.sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                    multi_output=True, normalization="valid",
                                    use_ignore=True, ignore_label=-1,
                                    name="cls_prob")
    loc_diff = loc_preds - mx.sym.BlockGrad(loc_target)
    masked = mx.sym.BlockGrad(loc_mask) * mx.sym.smooth_l1(loc_diff, scalar=1.0)
    denom = mx.sym.BlockGrad(mx.sym.Reshape(mx.sym.sum(loc_mask) + 1.0,
                                            shape=(1, 1)))
    loc_loss = mx.sym.MakeLoss(mx.sym.broadcast_div(masked, denom),
                               grad_scale=1.0, name="loc_loss")
    return mx.sym.Group([cls_prob, loc_loss,
                         mx.sym.BlockGrad(cls_target, name="cls_t"),
                         mx.sym.BlockGrad(loc_target, name="loc_t")])


def get_ssd_detect(num_classes=2, nms_threshold=0.5):
    """Inference symbol: softmax, then MultiBoxDetection's decode and
    NMS."""
    data = mx.sym.Variable("data")
    loc_preds, cls_preds, anchors = get_ssd_body(data, num_classes)
    cls_prob = mx.sym.SoftmaxActivation(data=cls_preds, mode="channel")
    return mx.sym.MultiBoxDetection(cls_prob=cls_prob, loc_pred=loc_preds,
                                    anchor=anchors, threshold=0.1,
                                    nms_threshold=nms_threshold, name="det")
