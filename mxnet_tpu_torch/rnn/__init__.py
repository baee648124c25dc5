"""RNN toolkit (reference: mxnet_tpu/rnn): cells, the bucketed sentence
iterator and the checkpoint helpers."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ZoneoutCell, ModifierCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import rnn_unroll, save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint
