"""Parallel building blocks (reference: mxnet_tpu/parallel). Only the plain
attention body is ported so far; ring attention over a device mesh waits for
the multi-device work."""
