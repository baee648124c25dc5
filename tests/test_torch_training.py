"""The port's gradients against the JAX package's, on the CPU: the flash
attention ``autograd.Function`` against ``jax.vjp`` of the reference's
``flash_attention`` (its Pallas forward in interpret mode, its recompute
backward), the loss-op protocol of ``SoftmaxOutput`` and of
``FusedCrossEntropyHead``, the LM's other op bodies, and the Executor's
``grad_req`` modes and ``backward(out_grads)``. Inputs and head gradients are
made with numpy and fed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu.ops.flash_attention import flash_attention as jax_flash
from mxnet_tpu.ops.registry import OpCtx as JOpCtx
from mxnet_tpu_torch import ops as tops
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.registry import OpCtx as TOpCtx

# fp32 gradients through autograd against jax.vjp: rtol 1e-4, atol 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_vjp(fn, inputs, head):
    """Outputs and input cotangents of ``fn`` under ``jax.vjp``."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(head))]


def _torch_grad(fn, inputs, head):
    """Outputs and input gradients of ``fn`` under autograd."""
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(head))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# flash attention


@pytest.mark.parametrize("causal,q_offset,t_q,t_k", [
    (False, 0, 32, 32), (True, 0, 32, 32), (True, 16, 16, 32),
    (False, 0, 16, 32)])
def test_flash_gradient_matches_jax_vjp(causal, q_offset, t_q, t_k):
    """dq, dk, dv of the Function (forward: the plain version on the CPU)
    against ``jax.vjp`` of the reference, whose forward is the Pallas kernel
    in interpret mode; a random head gradient."""
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 2, t, 4, 8) for t in (t_q, t_k, t_k))
    head = _rand(rng, 2, t_q, 4, 8)
    kw = dict(causal=causal, q_offset=q_offset, block_q=16, block_k=16)
    want = _jax_vjp(lambda *a: jax_flash(*a, interpret=True, **kw),
                    (q, k, v), head)
    before = dict(tfa.flash_attention.launches_by_dtype)
    got = _torch_grad(lambda *a: tfa.flash_attention(*a, **kw), (q, k, v),
                      head)
    _close([got[0]] + got[1], [want[0]] + want[1])
    # nothing launches on the CPU, forward or backward
    assert tfa.flash_attention.launches_by_dtype == before


def test_flash_gradient_bf16_matches_jax_vjp():
    """bf16 inputs: the forward and the fp32 recompute cast back to bf16,
    as the reference's ``bwd``; gradients come back in bf16. Seeds 1, 11
    and 21 read equal outputs and gradients within 1.9e-6; the limit is
    one bf16 step of a gradient in [1, 2) (2^-7)."""
    rng = np.random.default_rng(1)
    q, k, v, head = (_rand(rng, 1, 32, 2, 16) for _ in range(4))

    def jfn(*a):
        return jax_flash(*(x.astype(jnp.bfloat16) for x in a), causal=True,
                         interpret=True).astype(jnp.float32)

    want = _jax_vjp(jfn, (q, k, v), head)
    xs = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*xs, causal=True)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, xs, torch.from_numpy(head).bfloat16())
    assert all(g.dtype == torch.bfloat16 for g in grads)
    _close([out.float().detach().numpy()] + [g.float().numpy()
                                              for g in grads],
           [want[0]] + want[1], rtol=0, atol=2 ** -7)


def test_flash_gradient_saves_only_inputs():
    """Only q, k and v are kept for the backward (the reference's
    residuals): no (T, T) tensor is saved."""
    q, k, v = (torch.randn(1, 64, 2, 8, requires_grad=True) for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3
    assert all(s.shape == (1, 64, 2, 8) for s in saved)


# ---------------------------------------------------------------------------
# SoftmaxOutput: the loss-op protocol


def _op_pair(name, attrs, inputs, head, wrt):
    """The op body of ``name`` in both packages, differentiated in the
    inputs numbered ``wrt`` with head gradient ``head``."""
    jop, top = jops.get_op(name), tops.get_op(name)

    def jfn(*diff):
        ins = [jnp.asarray(a) for a in inputs]
        for i, d in zip(wrt, diff):
            ins[i] = d
        outs, _ = jop.normalized_call(JOpCtx(), attrs, ins, [])
        return outs[0]

    def tfn(*diff):
        ins = [torch.from_numpy(a) for a in inputs]
        for i, d in zip(wrt, diff):
            ins[i] = d
        outs, _ = top.normalized_call(TOpCtx(device=torch.device("cpu")),
                                      attrs, ins, [])
        return outs[0]

    diff = [inputs[i] for i in wrt]
    return _torch_grad(tfn, diff, head), _jax_vjp(jfn, diff, head)


def _labels(rng, shape, classes, ignore=True):
    lab = rng.integers(0, classes, shape).astype(np.float32)
    if ignore:
        lab.reshape(-1)[::3] = -1     # every third position ignored
    return lab


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("layout", ["last", "channel"])
def test_softmax_output_backward_matches_reference(norm, use_ignore, layout):
    """(p - onehot) * scale for each normalisation, with and without
    ``use_ignore``, on the last axis and on the channel axis (3-d data),
    under a random head gradient that both packages ignore."""
    rng = np.random.default_rng(2)
    shape, lshape = ((6, 10), (6,)) if layout == "last" \
        else ((3, 10, 4), (3, 4))
    data = _rand(rng, *shape, scale=2.0)
    label = _labels(rng, lshape, 10)
    attrs = {"normalization": norm, "use_ignore": use_ignore,
             "ignore_label": -1, "grad_scale": 1.5}
    head = _rand(rng, *shape)
    (got_p, (got_g,)), (want_p, (want_g,)) = _op_pair(
        "SoftmaxOutput", attrs, [data, label], head, [0])
    _close([got_p, got_g], [want_p, want_g])


def test_softmax_output_ignores_head_gradient():
    """The gradient is the same under any head gradient, and is not what
    plain autograd of softmax gives: the loss-op protocol is in force."""
    rng = np.random.default_rng(3)
    data, head = _rand(rng, 5, 7), _rand(rng, 5, 7)
    label = _labels(rng, (5,), 7, ignore=False)
    attrs = {"normalization": "batch"}
    (_, (g_rand,)), _ = _op_pair("SoftmaxOutput", attrs, [data, label],
                                 head, [0])
    (_, (g_ones,)), _ = _op_pair("SoftmaxOutput", attrs, [data, label],
                                 np.ones_like(head), [0])
    np.testing.assert_array_equal(g_rand, g_ones)
    x = torch.from_numpy(data).requires_grad_()
    (plain,) = torch.autograd.grad(torch.softmax(x, -1), x,
                                   torch.from_numpy(head))
    assert np.abs(plain.numpy() - g_rand).max() > 0.1


def test_softmax_output_amp_grad_reaches_bf16_logits():
    """Under amp the bf16 logits are cast to fp32 before the loss; the
    gradient comes back through that cast in bf16."""
    x = torch.randn(4, 9).bfloat16().requires_grad_()
    label = torch.tensor([1.0, 2.0, -1.0, 8.0])
    p = tops.get_op("SoftmaxOutput").fn(
        TOpCtx(), {"use_ignore": True, "normalization": "valid"}, x, label)
    assert p.dtype == torch.float32
    (g,) = torch.autograd.grad(p, x, torch.ones_like(p))
    assert g.dtype == torch.bfloat16
    assert bool((g[2] == 0).all()) and bool(g[[0, 1, 3]].abs().sum() > 0)


# ---------------------------------------------------------------------------
# FusedCrossEntropyHead


def _fused_attrs(**kw):
    attrs = {"num_classes": 100, "chunk_size": 32, "use_ignore": True,
             "ignore_label": -1, "normalization": "valid"}
    attrs.update(kw)
    return attrs


@pytest.mark.parametrize("no_bias", [False, True])
@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_fused_head_matches_reference(no_bias, norm):
    """NLL and dx, dw, db against the reference on a ragged vocabulary (100
    classes in chunks of 32), under a random head gradient."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 12, 16), _rand(rng, 100, 16, scale=0.5)
    b = _rand(rng, 100, scale=0.1)
    label = _labels(rng, (12,), 100)
    attrs = _fused_attrs(no_bias=no_bias, normalization=norm,
                         grad_scale=0.7)
    inputs = [x, w, label] if no_bias else [x, w, b, label]
    wrt = [0, 1] if no_bias else [0, 1, 2]
    head = _rand(rng, 12)
    (got_nll, got), (want_nll, want) = _op_pair(
        "FusedCrossEntropyHead", attrs, inputs, head, wrt)
    assert got_nll.dtype == np.float32 and got_nll.shape == (12,)
    assert np.all(got_nll[label == -1] == 0)
    _close([got_nll] + got, [want_nll] + want)


def test_fused_head_matches_dense_head():
    """The fused head's gradients equal the dense head's (FullyConnected then
    SoftmaxOutput) in the port itself, and its NLL is -log p(label)."""
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 10, 8), _rand(rng, 50, 8), _rand(rng, 50)
    label = _labels(rng, (10,), 50)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    lab = torch.from_numpy(label)
    attrs = {"use_ignore": True, "ignore_label": -1,
             "normalization": "valid"}
    nll = tops.get_op("FusedCrossEntropyHead").fn(
        TOpCtx(), dict(attrs, num_classes=50, chunk_size=16), *xs, lab)
    fused = torch.autograd.grad(nll, xs, torch.ones_like(nll))
    logits = tops.get_op("FullyConnected").fn(TOpCtx(), {"num_hidden": 50},
                                              *xs)
    p = tops.get_op("SoftmaxOutput").fn(TOpCtx(), attrs, logits, lab)
    dense = torch.autograd.grad(p, xs, torch.ones_like(p))
    _close([g.numpy() for g in fused], [g.numpy() for g in dense])
    keep = label != -1
    want = -np.log(p.detach().numpy()[keep, label[keep].astype(int)])
    np.testing.assert_allclose(nll.detach().numpy()[keep], want, rtol=1e-5)


def test_fused_head_bf16_matches_reference():
    """bf16 data and weight (as under amp): the projection in bf16, the
    statistics and dx's sum across chunks in fp32, in both packages. Both
    round each logit to bf16 after a sum taken in another order, so a
    logit may land one bf16 step apart (2^-6 = 0.0156 in [2, 4)): the NLL
    is held to two such steps (seeds 6, 16, 26 read 3.7e-3, 7.1e-3,
    1.0e-2) and dx, dw, db to 1.5 % of their largest entry (read
    2.5e-3-6.0e-3)."""
    rng = np.random.default_rng(6)
    x, w = _rand(rng, 16, 32), _rand(rng, 100, 32, scale=0.3)
    b, label = _rand(rng, 100, scale=0.1), _labels(rng, (16,), 100)
    attrs = _fused_attrs()

    def jfn(x, w, b):
        outs, _ = jops.get_op("FusedCrossEntropyHead").normalized_call(
            JOpCtx(), attrs, [x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                              b.astype(jnp.bfloat16), jnp.asarray(label)], [])
        return outs[0]

    def tfn(x, w, b):
        return tops.get_op("FusedCrossEntropyHead").fn(
            TOpCtx(), attrs, x.bfloat16(), w.bfloat16(), b.bfloat16(),
            torch.from_numpy(label))

    head = np.ones(16, np.float32)
    got_nll, got = _torch_grad(tfn, (x, w, b), head)
    want_nll, want = _jax_vjp(jfn, (x, w, b), head)
    np.testing.assert_allclose(got_nll, want_nll, rtol=0, atol=3e-2)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, rtol=0,
                                   atol=1.5e-2 * np.abs(wnt).max())


def test_fused_head_shape_inference_and_symbol():
    net = mxt.models.transformer_lm.get_symbol(
        vocab_size=64, num_layers=1, hidden=16, heads=2, seq_len=8,
        fused_head=True)
    args, outs, _ = net.infer_shape(data=(2, 8), softmax_label=(2, 8))
    names = net.list_arguments()
    assert dict(zip(names, args))["head_weight"] == (64, 16)
    assert dict(zip(names, args))["head_bias"] == (64,)
    assert outs == [(16,)]
    ref = mxj.models.transformer_lm.get_symbol(
        vocab_size=64, num_layers=1, hidden=16, heads=2, seq_len=8,
        fused_head=True)
    assert names == ref.list_arguments()
    assert net.list_outputs() == ref.list_outputs()


# ---------------------------------------------------------------------------
# the LM's other ops


@pytest.mark.parametrize("name,attrs,makers,wrt", [
    ("FullyConnected", {"num_hidden": 6},
     [lambda r: _rand(r, 4, 3, 5), lambda r: _rand(r, 6, 15),
      lambda r: _rand(r, 6)], [0, 1, 2]),
    ("Activation", {"act_type": "relu"}, [lambda r: _rand(r, 3, 7)], [0]),
    ("Activation", {"act_type": "sigmoid"}, [lambda r: _rand(r, 3, 7)], [0]),
    ("Activation", {"act_type": "tanh"}, [lambda r: _rand(r, 3, 7)], [0]),
    ("Activation", {"act_type": "softrelu"}, [lambda r: _rand(r, 3, 7)],
     [0]),
    ("LayerNorm", {}, [lambda r: _rand(r, 2, 5, 8), lambda r: _rand(r, 8),
                       lambda r: _rand(r, 8)], [0, 1, 2]),
    # repeated ids: the weight's gradient is a scatter-add
    ("Embedding", {"input_dim": 6, "output_dim": 4},
     [lambda r: np.array([[1, 1, 3], [1, 5, 3]], np.float32),
      lambda r: _rand(r, 6, 4)], [1]),
    # ids outside [-6, 6) give NaN rows and a zero gradient, never NaN
    ("Embedding", {"input_dim": 6, "output_dim": 4},
     [lambda r: np.array([[-1, 7, 2], [np.nan, -9, 2]], np.float32),
      lambda r: _rand(r, 6, 4)], [1]),
])
def test_op_gradients_match_reference(name, attrs, makers, wrt):
    rng = np.random.default_rng(7)
    inputs = [m(rng) for m in makers]
    (got_out, got), (want_out, want) = _op_pair(
        name, attrs, inputs, _head_like(name, attrs, inputs), wrt)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-6)
    for g in got:
        assert np.isfinite(g).all()
    _close(got, want)


def _head_like(name, attrs, inputs):
    """A random head gradient of the op's output shape, zero where the
    output is NaN (a masked Embedding row)."""
    out, _ = tops.get_op(name).normalized_call(
        TOpCtx(), attrs, [torch.from_numpy(a) for a in inputs], [])
    out = out[0].numpy()
    head = np.random.default_rng(8).standard_normal(out.shape)
    return np.where(np.isnan(out), 0.0, head).astype(np.float32)


def test_embedding_amp_scatter_add_in_bf16():
    """Under amp the embedding weight is cast to bf16 in the walk, so the
    repeated-id scatter-add sums in bf16 in both packages."""
    rng = np.random.default_rng(9)
    ids = np.array([[2, 2, 2, 2, 0]], np.float32)
    w = _rand(rng, 4, 8)
    head = _rand(rng, 1, 5, 8)

    def jfn(w):
        return jops.get_op("Embedding").fn(
            JOpCtx(), {"input_dim": 4, "output_dim": 8}, jnp.asarray(ids),
            w.astype(jnp.bfloat16)).astype(jnp.float32)

    def tfn(w):
        return tops.get_op("Embedding").fn(
            TOpCtx(), {"input_dim": 4, "output_dim": 8}, torch.from_numpy(ids),
            w.bfloat16()).float()

    _, (want,) = _jax_vjp(jfn, (w,), head)
    _, (got,) = _torch_grad(tfn, (w,), head)
    # four bf16 additions into row 2: a bf16 step of the sum apart at most
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Executor: grad_req and backward(out_grads)


def _mlp(pkg):
    x = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(x, num_hidden=5, name="fc1"),
                           act_type="tanh")
    return pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")


def _mlp_arrays(rng):
    return {"data": _rand(rng, 4, 6), "fc1_weight": _rand(rng, 5, 6),
            "fc1_bias": _rand(rng, 5), "fc2_weight": _rand(rng, 3, 5),
            "fc2_bias": _rand(rng, 3)}


def _bind(pkg, arrays, grad_req, grads_for):
    ctx = pkg.cpu()
    args = {n: pkg.nd.array(a, ctx) for n, a in arrays.items()}
    grads = {n: pkg.nd.ones(arrays[n].shape, ctx) for n in grads_for}
    return _mlp(pkg).bind(ctx, args, args_grad=grads, grad_req=grad_req)


@pytest.mark.parametrize("grad_req", [
    "write", "add", "null", ["null", "write", "add", "write", "null"],
    {"fc1_weight": "add", "fc2_bias": "write"}])
def test_executor_grad_req_matches_reference(grad_req):
    """grad_req as a string, a list and a dict; write replaces, add
    accumulates onto the bound array (here ones), null leaves it; a request
    on an argument with no grad array (``data``) is null. Two backward
    passes after two forwards, so ``add`` sums twice."""
    rng = np.random.default_rng(10)
    arrays = _mlp_arrays(rng)
    grads_for = [n for n in arrays if n != "data"]
    head = [_rand(rng, 4, 3)]
    res = {}
    for pkg in (mxj, mxt):
        ex = _bind(pkg, arrays, grad_req, grads_for)
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward([pkg.nd.array(head[0], pkg.cpu())])
        res[pkg] = ({n: ex.grad_dict[n].asnumpy() for n in grads_for},
                    ex.outputs[0].asnumpy(), ex.grad_req)
    got, want = res[mxt], res[mxj]
    assert got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    for n in grads_for:
        np.testing.assert_allclose(got[0][n], want[0][n], rtol=RTOL,
                                   atol=ATOL)


def test_executor_backward_out_grads_reruns_observed_forward():
    """``backward(out_grads)`` differentiates the forward the caller saw,
    with those head gradients; ``backward()`` after a train forward uses
    ones. Both match the reference Executor."""
    rng = np.random.default_rng(11)
    arrays = _mlp_arrays(rng)
    grads_for = [n for n in arrays if n != "data"]
    head = _rand(rng, 4, 3)
    res = {}
    for pkg in (mxj, mxt):
        ex = _bind(pkg, arrays, "write", grads_for)
        ex.forward(is_train=True)
        ex.backward()
        ones = {n: ex.grad_dict[n].asnumpy() for n in grads_for}
        ex.backward(pkg.nd.array(head, pkg.cpu()))
        given = {n: ex.grad_dict[n].asnumpy() for n in grads_for}
        res[pkg] = (ones, given)
    for got, want in zip(res[mxt], res[mxj]):
        for n in grads_for:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL)
    assert np.abs(res[mxt][0]["fc2_bias"] - res[mxt][1]["fc2_bias"]).max() \
        > 1e-2


def test_executor_train_forward_keeps_bound_arrays_out_of_autograd():
    """Each train forward takes fresh leaves: the bound arrays never require
    grad, so updating them records no graph; the outputs carry none."""
    rng = np.random.default_rng(12)
    ex = _bind(mxt, _mlp_arrays(rng), "write", ["fc1_weight", "fc2_weight"])
    (out,) = ex.forward(is_train=True)
    assert not out.data.requires_grad and out.data.grad_fn is None
    assert not any(a.data.requires_grad for a in ex.arg_dict.values())
    ex.backward()
    assert all(ex.grad_dict[n].dtype == torch.float32
               for n in ("fc1_weight", "fc2_weight"))
    with pytest.raises(mxt.MXNetError):
        ex.backward()


def test_simple_bind_and_infer_type():
    net = _mlp(mxt)
    ex = net.simple_bind(mxt.cpu(), data=(4, 6))
    assert ex.grad_dict["fc1_weight"].shape == (5, 6)
    ex.forward(is_train=True)
    ex.backward()
    assert np.abs(ex.grad_dict["fc2_bias"].asnumpy() - 4.0).max() < 1e-6
    want = _mlp(mxj).infer_type(data="float32")
    assert net.infer_type(data="float32") == want
