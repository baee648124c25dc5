"""Model symbol builders ported so far (reference: mxnet_tpu/models): each
module has ``get_symbol(num_classes, ...)``, and :func:`get_model` finds one
by the name a training script passes (``--network``)."""
from . import lstm_lm, resnet, transformer_lm

__all__ = ["lstm_lm", "resnet", "transformer_lm", "get_model"]

_MODELS = {"resnet": resnet, "transformer_lm": transformer_lm}


def get_model(name):
    return _MODELS[name]
