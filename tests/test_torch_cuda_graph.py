"""The fused training step captured as a CUDA graph, on the card: captured
steps against the same step function run eagerly from the same start
(weights, states and outputs), for a small MLP, a BatchNorm convolution net
in bf16, an unrolled LSTM with Dropout (the masks of a replay are the eager
step's) and the fused ``RNN`` op; learning rates that change between
replays; a batch of another shape and a rebind dropping the graph; a
capture that fails raising with the op it failed in; and the buckets of a
``BucketingModule``, each graph in a pool of its own. This file imports no
JAX, so it runs on a machine with only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_graph.py

Where two eager runs are bit-identical the captured run must be too, else
within 1e-5 of each array's max-abs. fp32 with TF32 off. Without a CUDA
device each test skips."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import get_op, rnn_op

pytestmark = pytest.mark.gpu
LIMIT = 1e-5


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    for k in ("MXTPU_NO_FUSED_STEP", "MXTPU_FUSED_GRADS",
              "MXTPU_DONATE_PARAMS", "MXNET_RUN_N_STEPS"):
        monkeypatch.delenv(k, raising=False)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


def _mlp():
    x = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64,
                              name="fc1")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.FullyConnected(x, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _bn_net():
    x = mx.sym.Convolution(mx.sym.Variable("data"), num_filter=8,
                           kernel=(3, 3), pad=(1, 1), name="conv")
    x = mx.sym.BatchNorm(x, fix_gamma=False, name="bn")
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _lstm_dropout(seq=6, vocab=50, hidden=32):
    data = mx.sym.Variable("data")
    x = mx.sym.Embedding(data, input_dim=vocab, output_dim=16, name="embed")
    x = mx.sym.Dropout(x, p=0.3, name="drop_in")
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(num_hidden=hidden, prefix="l0_"))
    outs, _ = stack.unroll(seq, inputs=x, layout="NTC", merge_outputs=True)
    x = mx.sym.Dropout(mx.sym.Reshape(outs, shape=(-1, hidden)), p=0.3,
                       name="drop_out")
    x = mx.sym.FullyConnected(x, num_hidden=vocab, name="pred")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(x, label, name="softmax")


def _fused_rnn(seq=6, vocab=50, hidden=32):
    return mx.models.lstm_lm.fused_sym_gen_factory(
        num_hidden=hidden, num_embed=16, num_layers=2,
        vocab_size=vocab)(seq)[0]


def _batches(kind, n, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if kind == "mlp":
            x = rng.standard_normal((batch, 20)).astype(np.float32)
            y = rng.integers(0, 10, batch).astype(np.float32)
        elif kind == "bn":
            x = rng.standard_normal((batch, 3, 16, 16)).astype(np.float32)
            y = rng.integers(0, 10, batch).astype(np.float32)
        else:
            x = rng.integers(0, 50, (batch, 6)).astype(np.float32)
            y = rng.integers(0, 50, (batch, 6)).astype(np.float32)
        out.append(mx.io.DataBatch(data=[mx.nd.array(x, mx.cpu())],
                                   label=[mx.nd.array(y, mx.cpu())]))
    return out


def _module(symbol, batch, seed=1, amp=None, optimizer="sgd", **opt):
    mod = mx.mod.Module(symbol, context=mx.gpu(0), amp=amp)
    mod.bind(data_shapes=[("data", batch.data[0].shape)],
             label_shapes=[("softmax_label", batch.label[0].shape)])
    rng = np.random.default_rng(seed)
    ex = mod._exec_group._executor
    args = {n: mx.nd.array((rng.standard_normal(ex.arg_dict[n].shape)
                            * 0.2).astype(np.float32), mx.cpu())
            for n in mod._param_names}
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt or {
        "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
    return mod


def _train(symbol, batches, capture, seed_random=7, **kw):
    mx.random.seed(seed_random)
    mod = _module(symbol, batches[0], **kw)
    mod._fused_step_fn.capturable = capture
    outs = []
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].data.float().clone())
    args, auxs = mod.get_params()
    arrays = [args[k].data for k in sorted(args)] \
        + [auxs[k].data for k in sorted(auxs)]
    for i in sorted(mod._updater.states):
        arrays += list(mod._optimizer._state_leaves(mod._updater.states[i]))
    return outs + arrays, mod


def _hold(got, want, exact):
    for a, b in zip(got, want):
        if exact:
            assert torch.equal(a, b)
        else:
            err = (a.float() - b.float()).abs().max().item()
            assert err <= LIMIT * max(1.0, b.float().abs().max().item())


def _captured_equals_eager(symbol, kind, **kw):
    batches = _batches(kind, 5)
    eager, _ = _train(symbol, batches, False, **kw)
    eager2, _ = _train(symbol, batches, False, **kw)
    got, mod = _train(symbol, batches, True, **kw)
    info = mod.step_info()
    assert info["captured"] and info["refusal"] is None, info
    assert (info["warmups"], info["captures"], info["replays"]) == (1, 1, 4)
    exact = all(torch.equal(a, b) for a, b in zip(eager, eager2))
    _hold(got, eager, exact)
    return mod


def test_mlp_captured_equals_eager():
    _captured_equals_eager(_mlp(), "mlp")


def test_bn_net_bf16_captured_equals_eager():
    mod = _captured_equals_eager(_bn_net(), "bn", amp="bfloat16")
    assert mod._exec_group._executor.aux_dict["bn_moving_mean"].data \
        .abs().sum().item() > 0


def test_unrolled_lstm_dropout_masks_equal():
    _captured_equals_eager(_lstm_dropout(), "lstm")


def test_fused_rnn_captured_or_refused():
    batches = _batches("lstm", 4)
    before = rnn_op.cudnn_calls
    got, mod = _train(_fused_rnn(), batches, True)
    info = mod.step_info()
    if info["captured"]:
        # the counter counts Python calls: the warm-up's and the capture's
        # (which records the call); a replay makes none
        assert rnn_op.cudnn_calls - before == 2
        eager, _ = _train(_fused_rnn(), batches, False)
        eager2, _ = _train(_fused_rnn(), batches, False)
        _hold(got, eager, all(torch.equal(a, b)
                              for a, b in zip(eager, eager2)))
    else:
        assert "RNN" in info["refusal"], info


def test_learning_rate_changes_between_replays(monkeypatch):
    """A FactorScheduler halving the rate every update: the captured steps
    equal the eager function, and the split path (the per-parameter ops,
    rates as Python floats) within the limit."""
    batches = _batches("mlp", 5)

    def run(capture, split=False):
        opt = mx.optimizer.SGD(
            learning_rate=0.1, rescale_grad=1 / 16,
            lr_scheduler=mx.lr_scheduler.FactorScheduler(step=1, factor=0.5))
        mx.random.seed(7)
        mod = mx.mod.Module(_mlp(), context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (16, 20))],
                 label_shapes=[("softmax_label", (16,))])
        rng = np.random.default_rng(1)
        ex = mod._exec_group._executor
        mod.init_params(arg_params={
            n: mx.nd.array((rng.standard_normal(ex.arg_dict[n].shape) * 0.2)
                           .astype(np.float32), mx.cpu())
            for n in mod._param_names})
        if split:
            monkeypatch.setenv("MXTPU_NO_FUSED_STEP", "1")
        mod.init_optimizer(optimizer=opt)
        monkeypatch.delenv("MXTPU_NO_FUSED_STEP", raising=False)
        if not split:
            mod._fused_step_fn.capturable = capture
        for b in batches:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
        args, _ = mod.get_params()
        return [args[k].data for k in sorted(args)], mod

    got, mod = run(True)
    assert mod.step_info()["replays"] == 4
    assert mod._optimizer.num_update == 5
    eager, _ = run(False)
    _hold(got, eager, True)
    split, mod = run(False, split=True)
    assert mod._fused_step_fn is None
    _hold(got, split, False)


def test_other_shape_and_rebind_drop_the_graph():
    batches = _batches("mlp", 3)
    mod = _module(_mlp(), batches[0])
    for b in batches:
        mod.forward(b, is_train=True)
        mod.update()
    step = mod._fused_step_fn
    assert step.captured and step.stats["captures"] == 1
    # a batch of another size rebinds the inputs: warm up and capture again
    for b in _batches("mlp", 3, batch=8, seed=3):
        mod.forward(b, is_train=True)
        mod.update()
        assert mod.get_outputs()[0].shape == (8, 10)
    assert (step.stats["warmups"], step.stats["captures"]) == (2, 2)
    mod.bind(data_shapes=[("data", (16, 20))],
             label_shapes=[("softmax_label", (16,))], force_rebind=True)
    assert mod._fused_step_fn is not step and not mod._fused_step_fn.captured


def test_capture_failure_raises_with_the_op(monkeypatch):
    op = get_op("Activation")
    body = op.fn

    def syncing(ctx, attrs, x):
        if x.device.type == "cuda":
            x.sum().item()   # reads back from the device: not capturable
        return body(ctx, attrs, x)

    monkeypatch.setattr(op, "fn", syncing)
    batches = _batches("mlp", 2)
    mod = _module(_mlp(), batches[0])
    mod.forward(batches[0], is_train=True)   # the eager warm-up runs
    mod.update()
    with pytest.raises(mx.MXNetError, match="Activation node"):
        mod.forward(batches[1], is_train=True)


def _buckets():
    import random

    random.seed(0)
    np.random.seed(0)
    mx.random.seed(0)
    sentences = [list(np.random.randint(1, 32, np.random.choice([4, 8])))
                 for _ in range(64)]
    it = mx.rnn.BucketSentenceIter(sentences, batch_size=8, buckets=[4, 8],
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(
        mx.models.lstm_lm.sym_gen_factory(num_hidden=16, num_embed=8,
                                          num_layers=1, vocab_size=32),
        default_bucket_key=it.default_bucket_key, context=mx.gpu(0))
    return it, mod


def test_bucket_graphs_capture_again_after_fit():
    """Each bucket captures its graph; after fit ends (it builds every step
    again) the next steps capture again."""
    it, mod = _buckets()
    seen = []
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Xavier(), eval_metric=None,
            batch_end_callback=lambda p: seen.append(mod.step_info()))
    assert all(seen[-1][k]["captured"] for k in (4, 8)), seen[-1]
    it.reset()
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.update()
    info = mod.step_info()
    assert all(info[k]["captured"] and info[k]["replays"] > 0
               for k in (4, 8)), info


def test_bucket_switch_between_forward_and_update():
    """Each bucket's graph has its own pool: a bucket's outputs and staged
    update stay as its step left them while another bucket replays."""
    it, mod = _buckets()
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    by_key = {}
    for _ in range(3):   # warm-up, capture and replay in both buckets
        it.reset()
        for batch in it:
            by_key.setdefault(batch.bucket_key, batch)
            mod.forward(batch, is_train=True)
            mod.update()
    info = mod.step_info()
    assert all(info[k]["captured"] for k in (4, 8)), info
    short = mod._buckets[4]
    mod.forward(by_key[4], is_train=True)
    outs = [o.data.clone() for o in short.get_outputs()]
    staged = [t.clone() for w, leaves in short._fused_pending
              for t in (w, *leaves)]
    mod.forward(by_key[8], is_train=True)
    mod.update()
    assert all(torch.equal(a, o.data)
               for a, o in zip(outs, short.get_outputs()))
    assert all(torch.equal(a, t) for a, t in zip(staged, [
        t for w, leaves in short._fused_pending for t in (w, *leaves)]))
