"""Train the PTB LSTM language model with bucketing (reference:
example/rnn/lstm_bucketing.py, the LSTM-PTB workload).

The same flags and defaults: 2 LSTM layers of 200, embedding 200, batch
32, buckets 10-60, SGD lr 0.01 momentum 0 wd 1e-5, Xavier (factor "in",
magnitude 2.34), ``Perplexity`` ignoring the pad label 0, ``Speedometer``.
``--fused-rnn 1`` runs the stack as one ``RNN`` node (cuDNN on the card).
Each bucket's step is ``fit``'s fused step, captured on the card as one
CUDA graph a bucket (each with a memory pool of its own) and replayed, as the
reference's step is a compiled program; ``MXTPU_NO_FUSED_STEP=1`` runs the
split path.
It reads ``ptb.train.txt``/``ptb.valid.txt`` from ``--data-dir`` when they
are there; otherwise it draws the reference's synthetic corpus
(``--num-sentences`` sentences with lengths uniform over the buckets and
``--vocab-size`` token ids, from ``--seed``; a tenth as many for
validation).

Run on the card: ``python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing``
(``--gpus 0``; ``--gpus 0,1`` trains data-parallel over two cards, the
split path); on the CPU: ``--cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

BUCKETS = [10, 20, 30, 40, 50, 60]
START_LABEL = 1
INVALID_LABEL = 0


def parser():
    ap = argparse.ArgumentParser(description="Train an LSTM LM on PTB")
    ap.add_argument("--data-dir", type=str, default="data/ptb")
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-hidden", type=int, default=200)
    ap.add_argument("--num-embed", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-epochs", type=int, default=25)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--mom", type=float, default=0.0)
    ap.add_argument("--wd", type=float, default=1e-5)
    ap.add_argument("--optimizer", type=str, default="sgd")
    ap.add_argument("--gpus", type=str, default="0",
                    help="the cards to train on, e.g. 0,1 (each takes an "
                         "even slice of the batch)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--disp-batches", type=int, default=50)
    ap.add_argument("--kv-store", type=str, default="local")
    ap.add_argument("--fused-rnn", type=int, default=0,
                    help="1 = one fused RNN node (cuDNN on the card)")
    ap.add_argument("--vocab-size", type=int, default=2000,
                    help="token ids of the synthetic corpus")
    ap.add_argument("--num-sentences", type=int, default=2000,
                    help="training sentences of the synthetic corpus")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic corpus")
    return ap


def tokenize_text(mx, fname, vocab=None, invalid_label=-1, start_label=0):
    with open(fname) as f:
        lines = [filter(None, i.split(" ")) for i in f.readlines()]
    return mx.rnn.encode_sentences(lines, vocab=vocab,
                                   invalid_label=invalid_label,
                                   start_label=start_label)


def synthetic_corpus(n_sentences, vocab_size, rng):
    """The reference's fallback corpus: lengths uniform over the buckets,
    ids uniform over [1, vocab_size)."""
    lengths = rng.choice(BUCKETS, n_sentences)
    return [list(rng.randint(1, vocab_size, n - 1)) for n in lengths]


def load_data(mx, args):
    """(train sentences, validation sentences, vocabulary size)."""
    train_file = os.path.join(args.data_dir, "ptb.train.txt")
    if os.path.exists(train_file):
        train, vocab = tokenize_text(mx, train_file, start_label=START_LABEL,
                                     invalid_label=INVALID_LABEL)
        val, _ = tokenize_text(
            mx, os.path.join(args.data_dir, "ptb.valid.txt"), vocab=vocab,
            invalid_label=INVALID_LABEL)
        return train, val, len(vocab) + START_LABEL
    logging.warning("PTB data not found at %s: using the synthetic corpus",
                    train_file)
    rng = np.random.RandomState(args.seed)
    train = synthetic_corpus(args.num_sentences, args.vocab_size, rng)
    val = synthetic_corpus(max(1, args.num_sentences // 10),
                           args.vocab_size, rng)
    return train, val, args.vocab_size


def main(argv=None, batch_end_callback=()):
    """Train as the reference does; ``batch_end_callback`` adds callbacks
    after the ``Speedometer``. Returns the module and the iterators."""
    args = parser().parse_args(argv)
    import mxnet_tpu_torch as mx

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    train_sent, val_sent, vocab_size = load_data(mx, args)
    data_train = mx.rnn.BucketSentenceIter(train_sent, args.batch_size,
                                           buckets=list(BUCKETS),
                                           invalid_label=INVALID_LABEL)
    data_val = mx.rnn.BucketSentenceIter(val_sent, args.batch_size,
                                         buckets=list(BUCKETS),
                                         invalid_label=INVALID_LABEL)
    factory = (mx.models.lstm_lm.fused_sym_gen_factory if args.fused_rnn
               else mx.models.lstm_lm.sym_gen_factory)
    sym_gen = factory(num_hidden=args.num_hidden, num_embed=args.num_embed,
                      num_layers=args.num_layers, vocab_size=vocab_size)
    ctx = [mx.cpu()] if args.cpu \
        else [mx.gpu(int(i)) for i in args.gpus.split(",")]
    model = mx.mod.BucketingModule(
        sym_gen=sym_gen, default_bucket_key=data_train.default_bucket_key,
        context=ctx)
    model.fit(
        train_data=data_train, eval_data=data_val,
        eval_metric=mx.metric.Perplexity(INVALID_LABEL),
        kvstore=args.kv_store, optimizer=args.optimizer,
        optimizer_params={"learning_rate": args.lr, "momentum": args.mom,
                          "wd": args.wd},
        initializer=mx.init.Xavier(factor_type="in", magnitude=2.34),
        num_epoch=args.num_epochs,
        batch_end_callback=[mx.callback.Speedometer(args.batch_size,
                                                    args.disp_batches),
                            *batch_end_callback])
    return model, data_train, data_val


if __name__ == "__main__":
    main()
