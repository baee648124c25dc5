"""The evaluation forward as one captured program a binding
(``mxnet_tpu_torch.module.step_graph.ForwardProgram``, used by
``Executor.forward(is_train=False)``).

On the CPU the forward runs eagerly; the CPU tests also stand a host graph
in for the CUDA graph (:class:`_HostGraph`: a capture keeps the function's
outputs as the static buffers, a replay runs the function again into them),
so the program's rules run here: outputs new at every forward,
``predict(merge_batches=True)`` equal to forwards one batch at a time, a
``Custom`` node refusing the capture with its reason, a feed through
``forward(**kwargs)`` copied in place (and one of another shape dropping
the graph; captures and drops counted), a sampling node drawing anew at
every forward, and ``storage.no_collection`` holding off the collector.

The card tests (marked ``gpu``, skipped without a card) hold the captured
forward bit-identical to the eager walk (LeNet, a small ResNet, the
transformer LM at depth 2 through ``Predictor``), a sampling node's replays,
``forward(data=x)`` feeds, one capture a binding through ``score``, an
evaluation forward between fused training steps, bucket switches under
evaluation, and no collection while a capture is under way. This file imports no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_forward_graph.py
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.module import step_graph


class _HostGraph:
    """A CUDA graph's stand-in on the CPU: ``replay`` runs the program's
    function again and writes its results into the static outputs. Like a
    CUDA graph's replay, it draws from the seed the program set on the host
    before the run (a capture does not advance a registered generator)."""

    def __init__(self, prog):
        self.prog = prog

    def replay(self):
        self.prog.rng.begin(self.prog.rng.seed)
        outs = self.prog._body()
        with torch.inference_mode():
            for s, o in zip(self.prog._static, outs):
                s.copy_(o)


@pytest.fixture
def host_graphs(monkeypatch):
    """Every ForwardProgram built while the test runs warms up, captures
    into a :class:`_HostGraph` and replays on the CPU (a refused graph
    stays eager)."""
    init = step_graph.ForwardProgram.__init__

    def host_init(prog, ex):
        init(prog, ex)
        prog.capturable = prog.refusal is None

    def warmup(prog, bound):
        prog.stats["warmups"] += 1
        prog._warm = bound
        return prog._body()

    def capture(prog, bound):
        prog.stats["captures"] += 1
        prog._static = prog._body()
        prog._graph = _HostGraph(prog)
        prog._bound = bound

    monkeypatch.setattr(step_graph.ForwardProgram, "__init__", host_init)
    monkeypatch.setattr(step_graph.ForwardProgram, "_warmup", warmup)
    monkeypatch.setattr(step_graph.ForwardProgram, "_capture", capture)


def _lenet_module(ctx, batch=4, seed=0):
    with mx.name.NameManager():
        net = mx.models.lenet.get_symbol(10)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (batch, 1, 28, 28))],
             label_shapes=[("softmax_label", (batch,))], for_training=False)
    mx.random.seed(seed)
    mod.init_params(mx.init.Xavier())
    return mod


def _batches(n, batch=4, seed=0, ctx=None):
    rng = np.random.default_rng(seed)
    ctx = ctx or mx.cpu()
    return [mx.io.DataBatch(
        data=[mx.nd.array(rng.standard_normal((batch, 1, 28, 28))
                          .astype(np.float32), ctx)],
        label=[mx.nd.array(rng.integers(0, 10, batch).astype(np.float32),
                           ctx)]) for _ in range(n)]


def test_cpu_runs_the_forward_eagerly():
    mod = _lenet_module(mx.cpu())
    ex = mod._exec_group._executor
    assert ex.forward_info() is None
    for b in _batches(3):
        mod.forward(b, is_train=False)
    info = ex.forward_info()
    assert info["refusal"] == "the CPU runs the evaluation forward eagerly"
    assert (info["captured"], info["eager_runs"], info["captures"]) \
        == (False, 3, 0)


def test_outputs_are_new_at_every_forward(host_graphs):
    mod = _lenet_module(mx.cpu())
    ex = mod._exec_group._executor
    batches = _batches(4)
    outs = []
    for b in batches:
        mod.forward(b, is_train=False)
        outs.append(mod.get_outputs()[0])
    info = ex.forward_info()
    assert (info["warmups"], info["captures"], info["replays"]) == (1, 1, 3)
    # each forward's output is its own array, not the graph's buffer
    assert len({id(o.data) for o in outs}) == 4
    assert all(o.data is not s for o in outs for s in
               ex._eval_program._static)
    for b, o in zip(batches, outs):
        ex.arg_dict["data"].data.copy_(b.data[0].data)
        assert torch.equal(o.data, ex.eager_forward()[0])
    assert not torch.equal(outs[0].data, outs[-1].data)


def test_predict_merged_equals_forwards_one_by_one(host_graphs):
    mod = _lenet_module(mx.cpu(), batch=4)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 1, 28, 28)).astype(np.float32)
    it = mx.io.NDArrayIter(x, np.zeros(16, np.float32), batch_size=4)
    merged = mod.predict(it, merge_batches=True).asnumpy()
    info = mod._exec_group._executor.forward_info()
    assert info["replays"] == 3 and info["captures"] == 1
    ref = _lenet_module(mx.cpu(), batch=4)
    ref_ex = ref._exec_group._executor
    want = []
    for i in range(4):
        ref_ex.arg_dict["data"].data.copy_(torch.from_numpy(x[i * 4:
                                                               i * 4 + 4]))
        want.append(ref_ex.eager_forward()[0].numpy())
    np.testing.assert_array_equal(merged, np.concatenate(want))
    # batches differ, so a merge of aliased buffers would repeat the last
    assert not np.array_equal(merged[:4], merged[-4:])


class _Halve(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * 0.5)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0] * 0.5)


@mx.operator.register("fwd_graph_halve")
class _HalveProp(mx.operator.CustomOpProp):
    def list_arguments(self):
        return ["data"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _Halve()


def test_custom_node_refuses_the_capture(host_graphs):
    data = mx.sym.Variable("data")
    net = mx.sym.Custom(mx.sym.FullyConnected(data, num_hidden=3,
                                              name="fc"),
                        op_type="fwd_graph_halve", name="halve")
    ex = net.simple_bind(mx.cpu(), data=(2, 4), grad_req="null")
    ex.arg_dict["fc_weight"][:] = np.ones((3, 4), np.float32)
    for _ in range(3):
        out = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out, np.zeros((2, 3)))
    info = ex.forward_info()
    assert "Custom node 'halve'" in info["refusal"]
    assert (info["captured"], info["eager_runs"], info["captures"]) \
        == (False, 3, 0)


def test_feed_through_forward_kwargs_drops_the_graph(host_graphs):
    """A feed through ``forward(**kwargs)`` of the bound shape and dtype is
    copied into the bound tensor and keeps the graph; one of another shape
    rebinds its argument, and the graph is dropped, warmed up and captured
    again (captures and drops counted)."""
    mod = _lenet_module(mx.cpu())
    ex = mod._exec_group._executor
    b = _batches(2)
    for _ in range(3):
        mod.forward(b[0], is_train=False)
    assert ex.forward_info()["captured"]
    bound = ex.arg_dict["data"].data
    x = b[1].data[0].asnumpy()
    out = ex.forward(is_train=False, data=x)[0].data.clone()
    assert ex.arg_dict["data"].data is bound
    info = ex.forward_info()
    assert (info["drops"], info["warmups"], info["captures"],
            info["replays"]) == (0, 1, 1, 3)
    ex.arg_dict["data"].data.copy_(torch.from_numpy(x))
    assert torch.equal(out, ex.eager_forward()[0])
    # another batch size rebinds: the next forward drops the graph and
    # warms up, the one after captures again
    small = x[:2].astype(np.float64)          # narrowed to float32
    out2 = ex.forward(is_train=False, data=small)[0].data.clone()
    assert ex.arg_dict["data"].shape == (2, 1, 28, 28)
    info = ex.forward_info()
    assert (info["drops"], info["warmups"], info["captures"]) == (1, 2, 1)
    assert not info["captured"]
    ex.forward(is_train=False)
    ex.forward(is_train=False)
    info = ex.forward_info()
    assert (info["drops"], info["warmups"], info["captures"],
            info["replays"]) == (1, 2, 2, 5)
    assert torch.equal(ex.outputs[0].data, out2)
    # the same rows at another batch size (the CPU's sums may part)
    np.testing.assert_allclose(out2.numpy(), out.numpy()[:2], rtol=1e-5,
                               atol=1e-7)


def _uniform_executor(ctx, shape=(64, 32)):
    """An evaluation-only graph whose output is a ``uniform`` draw plus its
    input."""
    x = mx.sym.Variable("x")
    net = mx.sym.uniform(shape=shape, name="draw") + x
    return net.bind(ctx, {"x": mx.nd.zeros(shape, ctx)}, grad_req="null")


def _eager_with_seed(ex, seed):
    from mxnet_tpu_torch.executor import NodeRandom

    rng = NodeRandom(ex._ctx.torch_device)
    rng.begin(seed)
    return ex.eager_forward(rng)[0]


def test_random_node_under_the_captured_forward(host_graphs):
    """A sampling node in an evaluation graph draws from the program's
    per-node generator: every forward (warm-up, capture, replays) draws
    new numbers from the step seed, as the eager function does on that
    seed; a re-seed gives the same numbers again."""
    ex = _uniform_executor(mx.cpu())
    mx.random.seed(11)
    outs, seeds = [], []
    for _ in range(4):
        outs.append(ex.forward(is_train=False)[0].data)
        seeds.append(ex._eval_program.rng.seed)
    info = ex.forward_info()
    assert (info["warmups"], info["captures"], info["replays"]) == (1, 1, 3)
    for i in range(3):
        assert not torch.equal(outs[i], outs[i + 1])
    for o, seed in zip(outs, seeds):
        assert torch.equal(o, _eager_with_seed(ex, seed))
    assert float(outs[0].min()) >= 0.0 and float(outs[0].max()) < 1.0
    mx.random.seed(11)
    again = _uniform_executor(mx.cpu())
    assert torch.equal(again.forward(is_train=False)[0].data, outs[0])


def test_predictor_feeds_in_place(host_graphs):
    mod = _lenet_module(mx.cpu())
    args, aux = mod.get_params()
    pred = mx.Predictor.from_arrays(
        mod.symbol, args, aux, {"data": (4, 1, 28, 28)}, ctx=mx.cpu())
    bound = pred._executor.arg_dict["data"].data
    xs = [b.data[0].asnumpy() for b in _batches(4, seed=5)]
    outs = [pred.forward(data=x).get_output(0) for x in xs]
    assert pred._executor.arg_dict["data"].data is bound
    info = pred._executor.forward_info()
    assert (info["captures"], info["replays"], info["drops"]) == (1, 3, 0)
    for x, o in zip(xs, outs):
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, mx.cpu())]),
                    is_train=False)
        np.testing.assert_array_equal(o, mod.get_outputs()[0].asnumpy())


def test_no_collection_pauses_the_collector():
    """No automatic collection runs inside ``no_collection``, however low
    the threshold, and the collector's state comes back after it (also
    where it was off, and after an exception)."""
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(inside[0])

    inside = [False]
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        with mx.storage.no_collection():
            inside[0] = True
            assert not gc.isenabled()
            junk = [[] for _ in range(1000)]
            for j in junk:
                j.append(j)
            del junk
            inside[0] = False
        assert gc.isenabled()
        junk = [[] for _ in range(1000)]
        del junk
        with pytest.raises(ValueError):
            with mx.storage.no_collection():
                raise ValueError
        assert gc.isenabled()
        gc.disable()
        with mx.storage.no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert seen and not any(seen)


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    for k in ("MXTPU_NO_FUSED_STEP", "MXTPU_FUSED_GRADS",
              "MXTPU_DONATE_PARAMS", "MXNET_RUN_N_STEPS"):
        monkeypatch.delenv(k, raising=False)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield mx.gpu(0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


def _captured_equals_eager(mod, batches):
    ex = mod._exec_group._executor
    for b in batches:
        mod.forward(b, is_train=False)
        got = mod.get_outputs()[0].data
        assert torch.equal(got, ex.eager_forward()[0])
    info = ex.forward_info()
    assert info["captured"] and info["captures"] == 1
    assert info["replays"] == len(batches) - 1
    return info


@pytest.mark.gpu
def test_lenet_captured_equals_eager_on_the_card(card):
    mod = _lenet_module(card, batch=8)
    _captured_equals_eager(mod, _batches(5, batch=8, ctx=card))


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_resnet_captured_equals_eager_on_the_card(card, amp):
    net = mx.models.resnet.get_symbol(10, 20, "3,32,32")
    mod = mx.mod.Module(net, context=card, amp=amp)
    mod.bind(data_shapes=[("data", (8, 3, 32, 32))],
             label_shapes=[("softmax_label", (8,))], for_training=False)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    rng = np.random.default_rng(1)
    batches = [mx.io.DataBatch(
        data=[mx.nd.array(rng.standard_normal((8, 3, 32, 32))
                          .astype(np.float32), card)],
        label=[mx.nd.zeros((8,), card)]) for _ in range(4)]
    _captured_equals_eager(mod, batches)


@pytest.mark.gpu
def test_lm_predictor_captured_equals_eager_on_the_card(card):
    sym = mx.models.transformer_lm.get_symbol(
        vocab_size=256, num_layers=2, hidden=64, heads=4, seq_len=128)
    shapes = {"data": (2, 128), "softmax_label": (2, 128)}
    rng = np.random.default_rng(0)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    pred = mx.Predictor.from_arrays(sym, params, {}, shapes, ctx=card)
    ex = pred._executor
    for _ in range(4):
        x = rng.integers(0, 256, (2, 128)).astype(np.float32)
        got = pred.forward(data=x).get_output_nd(0).data
        assert torch.equal(got, ex.eager_forward()[0])
    info = ex.forward_info()
    assert (info["captures"], info["replays"], info["drops"]) == (1, 3, 0)


@pytest.mark.gpu
def test_random_node_under_the_captured_forward_on_the_card(card):
    """Replays of an evaluation graph with a ``uniform`` node draw new
    numbers each forward, equal to the eager function's on the same seed
    (the node's generator is registered with the graph)."""
    ex = _uniform_executor(card)
    mx.random.seed(12)
    outs, seeds = [], []
    for _ in range(4):
        outs.append(ex.forward(is_train=False)[0].data)
        seeds.append(ex._eval_program.rng.seed)
    info = ex.forward_info()
    assert (info["captures"], info["replays"]) == (1, 3)
    for i in range(3):
        assert not torch.equal(outs[i], outs[i + 1])
    for o, seed in zip(outs, seeds):
        assert torch.equal(o, _eager_with_seed(ex, seed))


@pytest.mark.gpu
def test_forward_kwargs_feed_keeps_the_graph_on_the_card(card):
    """``forward(data=x)`` of the bound shape copies in place: one capture
    for the binding, each output the eager walk's on that feed."""
    mod = _lenet_module(card, batch=8)
    ex = mod._exec_group._executor
    for b in _batches(4, batch=8, seed=7):
        x = b.data[0].asnumpy()
        got = ex.forward(is_train=False, data=x)[0].data
        assert torch.equal(got, ex.eager_forward()[0])
    info = ex.forward_info()
    assert (info["captures"], info["replays"], info["drops"]) == (1, 3, 0)


@pytest.mark.gpu
def test_score_captures_once_a_binding(card):
    mod = _lenet_module(card, batch=8)
    rng = np.random.default_rng(3)
    it = mx.io.NDArrayIter(
        rng.standard_normal((48, 1, 28, 28)).astype(np.float32),
        rng.integers(0, 10, 48).astype(np.float32), batch_size=8)
    first = dict(mod.score(it, "acc"))["accuracy"]
    second = dict(mod.score(it, "acc"))["accuracy"]
    info = mod._exec_group._executor.forward_info()
    assert first == second
    assert (info["warmups"], info["captures"], info["replays"],
            info["drops"]) == (1, 1, 11, 0)


@pytest.mark.gpu
def test_eval_forward_between_fused_steps(card):
    """An evaluation forward between a fused step and its update keeps the
    staged update; the eval graph reads the weights the step installs in
    place, with no capture again."""
    with mx.name.NameManager():
        net = mx.models.lenet.get_symbol(10)
    mod = mx.mod.Module(net, context=card)
    batches = _batches(6, batch=8, ctx=card)
    mod.bind(data_shapes=[("data", (8, 1, 28, 28))],
             label_shapes=[("softmax_label", (8,))])
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    ex = mod._exec_group._executor
    evals = []
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        staged = mod._fused_pending
        mod.forward(batches[0], is_train=False)
        assert mod._fused_pending is staged
        evals.append(mod.get_outputs()[0].data)
        mod.update()
        mod.forward(batches[0], is_train=False)
        assert torch.equal(mod.get_outputs()[0].data, ex.eager_forward()[0])
    assert mod.step_info()["captured"]
    info = ex.forward_info()
    assert info["captures"] == 1 and info["drops"] == 0
    # the weights moved between steps, and the eval graph saw it
    assert not torch.equal(evals[0], evals[-1])


@pytest.mark.gpu
def test_bucket_switches_under_evaluation(card):
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
        default_bucket_key=it.default_bucket_key, context=card)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.init_params(initializer=mx.init.Xavier())
    by_key = {}
    for _ in range(3):
        it.reset()
        for batch in it:
            by_key.setdefault(batch.bucket_key, batch)
            mod.forward(batch, is_train=False)
            ex = mod._buckets[batch.bucket_key]._exec_group._executor
            assert torch.equal(mod.get_outputs()[0].data,
                               ex.eager_forward()[0])
    short = mod._buckets[4]
    mod.forward(by_key[4], is_train=False)
    out = short.get_outputs()[0].data.clone()
    mod.forward(by_key[8], is_train=False)
    assert torch.equal(out, short.get_outputs()[0].data)
    for key in (4, 8):
        info = mod._buckets[key]._exec_group._executor.forward_info()
        assert info["captured"] and info["captures"] == 1, (key, info)


@pytest.mark.gpu
def test_no_collection_during_a_capture(card):
    """A dropped binding's executor and program hold each other, so only a
    collection frees its graph; one that ran on the capturing thread during
    a capture would destroy that graph there and invalidate the capture.
    With the collector at its lowest threshold, none runs while a capture
    is under way and the capture holds."""
    seen = []

    def watch(phase, info):
        if phase == "start":
            seen.append(torch.cuda.is_current_stream_capturing())

    for _ in range(3):
        old = _lenet_module(card, batch=8)
        _captured_equals_eager(old, _batches(2, batch=8, ctx=card))
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        mod = _lenet_module(card, batch=8)
        _captured_equals_eager(mod, _batches(3, batch=8, ctx=card))
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert seen and not any(seen)
