"""Model symbol builders (reference: mxnet_tpu/models): each module has
``get_symbol(num_classes, ...)``, and :func:`get_model` finds one by the
name a training script passes (``--network``), with the reference's
aliases."""
from . import (alexnet, googlenet, inception_bn, inception_resnet_v2,
               inception_v3, lenet, lstm_lm, mlp, resnet, resnext,
               transformer_lm, vgg)

__all__ = ["mlp", "lenet", "alexnet", "vgg", "resnet", "inception_bn",
           "inception_v3", "inception_resnet_v2", "resnext", "googlenet",
           "lstm_lm", "transformer_lm", "get_model"]

_MODELS = {
    "mlp": mlp, "lenet": lenet, "alexnet": alexnet, "vgg": vgg,
    "resnet": resnet, "inception-bn": inception_bn, "inception_bn": inception_bn,
    "inception-v3": inception_v3, "inception_v3": inception_v3,
    "inception-resnet-v2": inception_resnet_v2,
    "inception_resnet_v2": inception_resnet_v2,
    "resnext": resnext, "googlenet": googlenet, "lstm_lm": lstm_lm,
    "transformer_lm": transformer_lm,
}


def get_model(name):
    return _MODELS[name]
