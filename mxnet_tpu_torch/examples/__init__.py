"""Runnable examples of the port (``python -m mxnet_tpu_torch.examples.<name>``)."""
