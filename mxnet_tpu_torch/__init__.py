"""mxnet_tpu_torch: the PyTorch and CUDA port of mxnet_tpu.

The same public names as ``mxnet_tpu`` (``nd``, ``sym``, ``mod``, ``init``,
``optimizer``, ``lr_scheduler``, ``metric``, ``callback``, ``model``,
``io``, ``recordio``, ``image``, ``rnn``, ``Predictor``, ``serving``,
``ModelServer``, ``GenerationSession``, ``engine``, ``kv``,
``distributed``, contexts), over ``torch.Tensor``s. Entry points run on
``gpu(0)`` unless the caller passes ``mx.cpu()``; importing the package
does not initialise CUDA. Kernels that the JAX package wrote in Pallas are
hand-written CUDA here: ``csrc/`` built with nvcc at first use, and users'
own kernels compiled at run time through NVRTC (``rtc``).
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, gpu, current_context, num_gpus
from .attribute import AttrScope
from .name import NameManager, Prefix

from . import engine
from . import ndarray
from . import operator  # registers Custom before nd/sym list the ops
from .operator import CustomOp, CustomOpProp, register as register_custom_op
from . import nd
from .ndarray import NDArray
from . import random
from . import storage
from . import rtc

from . import symbol
from . import symbol as sym
from .symbol import Symbol, Variable
from . import executor
from .executor import Executor
from . import initializer
from . import initializer as init
from .initializer import Initializer, Uniform, Normal, Xavier, Zero, One
from . import optimizer
from .optimizer import Optimizer
from . import lr_scheduler
from . import metric
from . import kvstore
from . import kvstore as kv
from . import kvstore_server  # exits server- and scheduler-role processes
from . import distributed
from . import io
from . import recordio
from . import image
from . import model
from . import callback
from . import module
from . import module as mod
from . import rnn
from . import predictor
from .predictor import Predictor
from . import convert
from . import models
from . import serving
from .serving import GenerationSession, ModelServer
