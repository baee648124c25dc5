"""Model symbol builders ported so far (reference: mxnet_tpu/models)."""
from . import transformer_lm  # noqa: F401
