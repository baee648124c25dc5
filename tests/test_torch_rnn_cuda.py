"""The LSTM slice on the card: the fused RNN op's cuDNN route against its
plain route (the step loop), per-node Dropout masks, and bucket modules
that share the default bucket's tensors. This file imports no JAX, so it
runs on a machine with only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_rnn_cuda.py

fp32 with TF32 off; the cuDNN route is held to the plain route within
1e-5 of each array's max-abs (at least 1e-5 absolute), outputs and
gradients. Without a CUDA device each test skips."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import rnn_op
from mxnet_tpu_torch.ops.registry import OpCtx

pytestmark = pytest.mark.gpu
LIMIT = 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32


def _close(got, want, what):
    err = (got - want).abs().max().item()
    assert err <= LIMIT * max(1.0, want.abs().max().item()), (what, err)


def rnn_case(mode, layers, bi, t=7, n=5, c=12, h=16, seed=0):
    """Inputs of the RNN op on the card (fp32), seeded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = 2 if bi else 1
    size = rnn_op.rnn_param_size(mode, layers, c, h, bi)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    # the flat vector from the initializer's ``_parameters`` rule,
    # U(-0.07, 0.07), the distribution the op trains from
    params = (torch.rand(size, generator=g, device="cuda") - 0.5) * 0.14
    ins = [rand(t, n, c), params, rand(layers * d, n, h, scale=0.5)]
    if mode == "lstm":
        ins.append(rand(layers * d, n, h, scale=0.5))
    attrs = {"mode": mode, "num_layers": layers, "state_size": h,
             "bidirectional": bi, "state_outputs": True}
    return attrs, ins


def run_route(attrs, ins, plain, is_train=True, seed=1):
    """Outputs and the gradients of data, parameters and states under
    seeded head gradients, by one route."""
    leaves = [x.detach().clone().requires_grad_() for x in ins]
    outs = rnn_op.rnn_forward(OpCtx(is_train=is_train,
                                    device=ins[0].device),
                              attrs, *leaves, plain=plain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    heads = [torch.randn(o.shape, generator=g, device="cuda") for o in outs]
    grads = torch.autograd.grad(outs, leaves, heads)
    return [o.detach() for o in outs], list(grads)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bi", [(1, False), (2, False), (2, True)])
def test_cudnn_route_matches_plain(mode, layers, bi):
    attrs, ins = rnn_case(mode, layers, bi)
    before = rnn_op.cudnn_calls
    got = run_route(attrs, ins, plain=None)
    assert rnn_op.cudnn_calls == before + 1
    want = run_route(attrs, ins, plain=True)
    assert rnn_op.cudnn_calls == before + 1
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _close(g, w, f"output {i}")
    for name, g, w in zip(("data", "parameters", "state", "state_cell"),
                          got[1], want[1]):
        _close(g, w, f"gradient of {name}")


@pytest.mark.parametrize("layers,bi", [(1, False), (2, False), (1, True)])
def test_cudnn_route_weight_buffer(recwarn, layers, bi):
    """cuDNN takes the flat vector as its buffer where its layout is the
    op's (one layer, one direction) and one gather of it elsewhere, never
    torch's copy of scattered weights (its 'not part of single contiguous
    chunk' warning); the gradient arrives in one array of the vector's
    shape."""
    attrs, ins = rnn_case("lstm", layers, bi, seed=3)
    before = rnn_op.weight_gathers
    _, grads = run_route(attrs, ins, plain=None)
    gathered = rnn_op.weight_gathers - before
    assert gathered == (0 if (layers, bi) == (1, False) else 1)
    assert grads[1].shape == ins[1].shape
    assert not [w for w in recwarn if "contiguous chunk" in str(w.message)]


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_cudnn_layer_dropout_matches_plain_on_fed_masks(monkeypatch, mode):
    """p > 0 in training runs cuDNN layer by layer with the op's own masks
    between layers (here fed), equal to the plain route on the same
    masks."""
    attrs, ins = rnn_case(mode, 3, True, seed=4)
    attrs["p"] = 0.3
    g = torch.Generator(device="cuda").manual_seed(5)
    masks = [torch.rand((7, 5, 32), generator=g, device="cuda") >= 0.3
             for _ in range(2)]
    drawn = []

    def fed(gen, keep, shape, device):
        m = masks[len(drawn) % 2]
        drawn.append(m)
        return m

    monkeypatch.setattr(tnn, "keep_mask", fed)
    before = rnn_op.cudnn_calls
    got = run_route(attrs, ins, plain=None)
    assert rnn_op.cudnn_calls == before + 3
    want = run_route(attrs, ins, plain=True)
    assert len(drawn) == 4
    for g_, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g_, w, "dropout route")


def _dropout_pair(first_random, shape=(4096, 1024), seed=7):
    sym = mx.sym
    first = (sym.uniform(shape=(2, 2), name="first") if first_random
             else sym._zeros(shape=(2, 2), name="first"))
    x = sym.Variable("x")
    net = sym.Group([first, sym.Dropout(x, p=0.5, name="da"),
                     sym.Dropout(x, p=0.5, name="db")])
    ctx = mx.gpu(0)
    ex = net.bind(ctx, {"x": mx.nd.ones(shape, ctx)},
                  args_grad={"x": mx.nd.zeros(shape, ctx)})
    mx.random.seed(seed)
    outs = ex.forward(is_train=True)
    return outs[1].data, outs[2].data, ex


def test_dropout_masks_per_node_on_the_card():
    """Two Dropout nodes of equal shape draw different masks; a node before
    them that draws numbers (in place of one that does not) leaves them
    as they were; the kept share is within 4 sigma of 1 - p; and
    ``backward(out_grads)`` reproduces the forward's masks."""
    a, b, ex = _dropout_pair(False)
    a2, b2, _ = _dropout_pair(True)
    assert (a != b).float().mean().item() > 0.3
    assert torch.equal(a, a2) and torch.equal(b, b2)
    n, p = a.numel(), 0.5
    kept = (a != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    ctx = mx.gpu(0)
    ex.backward([mx.nd.zeros((2, 2), ctx), mx.nd.ones(a.shape, ctx),
                 mx.nd.zeros(a.shape, ctx)])
    assert torch.equal(ex.grad_dict["x"].data, a)


def test_bucket_modules_share_the_default_buckets_tensors():
    rng = np.random.RandomState(0)
    sents = [list(rng.randint(1, 30, int(rng.choice([4, 8]))))
             for _ in range(64)]
    it = mx.rnn.BucketSentenceIter(sents, 8, buckets=[4, 8], invalid_label=0)
    mod = mx.mod.BucketingModule(
        mx.models.lstm_lm.sym_gen_factory(num_hidden=16, num_embed=8,
                                          num_layers=2, vocab_size=30),
        default_bucket_key=it.default_bucket_key, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    assert sorted(mod._buckets) == [4, 8]
    d_ex = mod._buckets[8]._exec_group._executor
    ex = mod._buckets[4]._exec_group._executor
    names = mod._buckets[8]._param_names
    for n in names:
        assert ex.arg_dict[n].data.data_ptr() == d_ex.arg_dict[n].data.data_ptr()
        assert ex.grad_dict[n].data.data_ptr() == \
            d_ex.grad_dict[n].data.data_ptr()
        assert ex.arg_dict[n].data.is_cuda
