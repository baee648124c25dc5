"""The data-parallel executor group, the port against the JAX package on
the CPU: ``Module`` over 1, 2 and 4 ``cpu(i)`` contexts (the reference's
one program over a mesh of as many CPU devices, the port's one replica a
context walked in lockstep), a Convolution + BatchNorm + FullyConnected +
SoftmaxOutput net from the same numpy weights and batches, 3 SGD-momentum
steps; the weights, BatchNorm's moving statistics and the merged outputs
agree at rtol 1e-5 and atol 1e-6 (the limit of
``tests/test_fused_step.py:204``), with no store, a ``local`` and a
``device`` ``KVStore`` object given to both packages. Each batch's halves
are drawn from different distributions, so statistics taken on a replica's
slice alone would fail the comparison (held below). Also ``decide_slices``
and its uneven-batch error, the refusal of duplicate contexts,
``BucketingModule`` over 2 contexts against the reference, and the port's
own paths over several contexts against one context: input gradients,
explicit head gradients, the losses' ``batch``/``valid`` normalisations,
a ``fit`` with ``kvstore="device"``.

The reference runs with graph rewrites off and its gradients readable
(``MXNET_GRAPHOPT=0``, ``MXTPU_FUSED_GRADS=1``)."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

BATCH, CH, PX, CLASSES, STEPS = 8, 2, 6, 5, 3
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)


def _net(pkg, norm="null", use_ignore=False):
    d = pkg.sym.Variable("data")
    c = pkg.sym.Convolution(d, kernel=(3, 3), num_filter=4, name="conv")
    b = pkg.sym.BatchNorm(c, fix_gamma=False, name="bn")
    f = pkg.sym.FullyConnected(pkg.sym.Flatten(b), num_hidden=CLASSES,
                               name="fc")
    return pkg.sym.SoftmaxOutput(f, normalization=norm, use_ignore=use_ignore,
                                 ignore_label=0, name="softmax")


def _weights(seed=1):
    shapes = _net(mxt).infer_shape(data=(BATCH, CH, PX, PX))[0]
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(_net(mxt).list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _batches(seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        x = rng.randn(BATCH, CH, PX, PX).astype(np.float32)
        # the second half of the batch from another distribution: a
        # replica's own statistics differ from the global batch's
        x[BATCH // 2:] = x[BATCH // 2:] * 2.0 + 1.5
        y = rng.randint(0, CLASSES, BATCH).astype(np.float32)
        out.append((x, y))
    return out


def _contexts(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _train(pkg, n, kvstore=None, net=None, batches=None):
    net = net if net is not None else _net(pkg)
    mod = pkg.mod.Module(net, context=_contexts(pkg, n))
    mod.bind(data_shapes=[("data", (BATCH, CH, PX, PX))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(
        arg_params={k: pkg.nd.array(v, pkg.cpu())
                    for k, v in _weights().items()},
        aux_params={"bn_moving_mean": pkg.nd.zeros((4,), pkg.cpu()),
                    "bn_moving_var": pkg.nd.ones((4,), pkg.cpu())})
    if kvstore in ("local", "device"):
        kvstore = pkg.kv.create(kvstore)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=SGD)
    for x, y in batches if batches is not None else _batches():
        batch = pkg.io.DataBatch([pkg.nd.array(x, pkg.cpu())],
                                 [pkg.nd.array(y, pkg.cpu())])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    args, auxs = mod.get_params()
    params = {k: v.asnumpy() for k, v in {**args, **auxs}.items()}
    return params, mod.get_outputs()[0].asnumpy(), mod


@pytest.mark.parametrize("kvstore", [None, "local", "device"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_module_over_contexts_matches_reference(n, kvstore):
    """Weights, moving statistics and merged outputs after 3 steps over
    ``n`` contexts; a ``KVStore`` object runs the update on the store in
    both packages."""
    got, got_out, mod = _train(mxt, n, kvstore)
    want, want_out, _ = _train(mxj, n, kvstore)
    assert len(mod._exec_group.execs) == n
    assert (mod._kvstore is not None) == (kvstore is not None)
    assert mod._fused_step_fn is None or n == 1 and kvstore is None
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got_out, want_out, rtol=RTOL, atol=ATOL)
    assert got_out.shape == (BATCH, CLASSES)


@pytest.mark.parametrize("n", [2, 4])
def test_batchnorm_statistics_are_the_global_batch(n):
    """Over ``n`` contexts the moving statistics after one step are those
    of the global batch (the one-context run's), every replica holds the
    same, and a replica's statistics alone would be far from them."""
    x, y = _batches()[0]
    one, _, _ = _train(mxt, 1, batches=[(x, y)])
    got, _, mod = _train(mxt, n, batches=[(x, y)])
    for k in ("bn_moving_mean", "bn_moving_var"):
        np.testing.assert_allclose(got[k], one[k], rtol=RTOL, atol=ATOL)
        for ex in mod._exec_group.execs:
            np.testing.assert_array_equal(ex.aux_dict[k].asnumpy(), got[k])
    # the first replica's slice alone: its variance is far from the batch's
    conv = mxt.nd.Convolution(
        mxt.nd.array(x[:BATCH // n], mxt.cpu()),
        mxt.nd.array(_weights()["conv_weight"], mxt.cpu()),
        mxt.nd.array(_weights()["conv_bias"], mxt.cpu()),
        kernel=(3, 3), num_filter=4).asnumpy()
    local_var = 0.9 + 0.1 * conv.var(axis=(0, 2, 3))
    assert np.abs(local_var - got["bn_moving_var"]).max() > 0.05


def test_replicas_hold_equal_parameters():
    _, _, mod = _train(mxt, 4)
    eg = mod._exec_group
    for name in eg.param_names:
        first = eg.execs[0].arg_dict[name].asnumpy()
        for ex in eg.execs[1:]:
            np.testing.assert_array_equal(ex.arg_dict[name].asnumpy(), first)
    assert [ex.arg_dict["data"].shape[0] for ex in eg.execs] == [2] * 4


def test_decide_slices_and_uneven_batch():
    """The port's ``decide_slices`` is the reference's: an even split of the
    batch axis; a batch the contexts do not divide raises in both."""
    shapes = [mxt.io.DataDesc("data", (8, 3))]
    for n in (1, 2, 4):
        got = mxt.mod.executor_group.decide_slices(shapes, _contexts(mxt, n))
        want = mxj.module.executor_group.decide_slices(
            [mxj.io.DataDesc("data", (8, 3))], _contexts(mxj, n))
        assert got == want
    with pytest.raises(mxt.MXNetError, match="not divisible"):
        mxt.mod.executor_group.decide_slices(
            [mxt.io.DataDesc("data", (6, 3))], _contexts(mxt, 4))
    with pytest.raises(mxj.MXNetError, match="not divisible"):
        mxj.module.executor_group.decide_slices(
            [mxj.io.DataDesc("data", (6, 3))], _contexts(mxj, 4))
    # the layout's batch axis, not always the first
    tnc = [mxt.io.DataDesc("data", (5, 8, 3), layout="TNC")]
    assert mxt.mod.executor_group.decide_slices(
        tnc, _contexts(mxt, 2)) == [slice(0, 4), slice(4, 8)]


def test_duplicate_contexts_are_refused():
    for pkg in (mxt, mxj):
        mod = pkg.mod.Module(_net(pkg), context=[pkg.cpu(0), pkg.cpu(0)])
        with pytest.raises(pkg.MXNetError, match="duplicate"):
            mod.bind(data_shapes=[("data", (BATCH, CH, PX, PX))],
                     label_shapes=[("softmax_label", (BATCH,))])


VOCAB, HIDDEN, EMBED, LAYERS, SEQ_BATCH = 24, 8, 6, 2, 4
BUCKETS = [4, 6, 8]


def _bucket_train(pkg, n):
    import random

    rng = np.random.RandomState(3)
    sentences = [list(rng.randint(1, VOCAB, int(rng.choice([3, 5, 8]))))
                 for _ in range(40)]
    random.seed(6)
    np.random.seed(6)
    it = pkg.rnn.BucketSentenceIter(sentences, SEQ_BATCH, buckets=BUCKETS,
                                    invalid_label=0)
    gen = pkg.models.lstm_lm.sym_gen_factory(
        num_hidden=HIDDEN, num_embed=EMBED, num_layers=LAYERS,
        vocab_size=VOCAB)
    sym = gen(max(BUCKETS))[0]
    shapes = {"data": (SEQ_BATCH, max(BUCKETS)),
              "softmax_label": (SEQ_BATCH, max(BUCKETS))}
    arg_shapes = sym.infer_shape(**shapes)[0]
    wrng = np.random.default_rng(5)
    weights = {k: (wrng.standard_normal(s) * 0.3).astype(np.float32)
               for k, s in zip(sym.list_arguments(), arg_shapes)
               if k not in shapes}
    mod = pkg.mod.BucketingModule(
        gen, default_bucket_key=it.default_bucket_key,
        context=_contexts(pkg, n), work_load_list=[1] * n)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, pkg.cpu())
                                for k, v in weights.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    keys = []
    for step, batch in enumerate(it):
        if step == 5:
            break
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        keys.append(batch.bucket_key)
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}, keys, mod


def test_bucketing_module_over_two_contexts_matches_reference():
    """``BucketingModule`` over 2 contexts (``work_load_list`` accepted),
    5 SGD steps over the buckets: the reference's weights; every bucket's
    replicas share the default bucket's arrays."""
    got, keys, mod = _bucket_train(mxt, 2)
    want, want_keys, _ = _bucket_train(mxj, 2)
    assert keys == want_keys and len(set(keys)) > 1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-5,
                                   err_msg=k)
    default = mod._buckets[max(BUCKETS)]._exec_group
    for m in mod._buckets.values():
        for r, ex in enumerate(m._exec_group.execs):
            for k in want:
                assert ex.arg_dict[k] is default.execs[r].arg_dict[k]


def _bound(n, net=None, inputs_need_grad=False):
    mod = mxt.mod.Module(net if net is not None else _net(mxt),
                         context=_contexts(mxt, n))
    mod.bind(data_shapes=[("data", (BATCH, CH, PX, PX))],
             label_shapes=[("softmax_label", (BATCH,))],
             inputs_need_grad=inputs_need_grad)
    mod.init_params(arg_params={k: mxt.nd.array(v, mxt.cpu())
                                for k, v in _weights().items()},
                    allow_missing=True, initializer=mxt.init.Zero())
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return mod


def _batch():
    x, y = _batches()[0]
    y[::3] = 0   # some labels the ignoring losses skip
    return mxt.io.DataBatch([mxt.nd.array(x, mxt.cpu())],
                            [mxt.nd.array(y, mxt.cpu())])


def test_input_grads_and_head_grads_merge_over_contexts():
    """``get_input_grads`` merges the replicas' data gradients along the
    batch; ``backward(out_grads)`` splits the head gradients over the
    replicas: both equal one context's."""
    res = {}
    heads = np.random.RandomState(4).randn(BATCH, CLASSES).astype("f4")
    for n in (1, 2):
        mod = _bound(n, net=mxt.sym.BatchNorm(
            mxt.sym.Convolution(mxt.sym.Variable("data"), kernel=(3, 3),
                                num_filter=4, name="conv"),
            fix_gamma=False, name="bn"), inputs_need_grad=True)
        b = mxt.io.DataBatch([_batch().data[0]], [])
        mod.forward(b, is_train=True)
        out = mod.get_outputs()[0]
        mod.backward([mxt.nd.array(np.broadcast_to(
            heads[:, :4, None, None], out.shape).copy(), mxt.cpu())])
        res[n] = (out.asnumpy(), mod.get_input_grads()[0].asnumpy(),
                  mod._exec_group.get_grads()["conv_weight"].asnumpy())
    for a, b in zip(res[1], res[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert res[2][1].shape == (BATCH, CH, PX, PX)


@pytest.mark.parametrize("norm,use_ignore", [("batch", False),
                                             ("valid", True),
                                             ("valid", False)])
def test_loss_normalisation_is_global(norm, use_ignore):
    """SoftmaxOutput's ``batch`` and ``valid`` normalisations over 2
    contexts divide by the global batch and the global count of valid
    labels: the gradients are one context's."""
    grads = {}
    for n in (1, 2):
        mod = _bound(n, net=_net(mxt, norm, use_ignore))
        mod.forward(_batch(), is_train=True)
        mod.backward()
        grads[n] = {k: v.asnumpy()
                    for k, v in mod._exec_group.get_grads().items()}
    for k in grads[1]:
        np.testing.assert_allclose(grads[2][k], grads[1][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_fit_over_contexts_with_device_kvstore():
    """``fit`` over 2 contexts with ``kvstore=mx.kv.create("device")``
    and a score: the weights and accuracy of one context's ``fit``."""
    x = np.concatenate([b[0] for b in _batches()])
    y = np.concatenate([b[1] for b in _batches()])
    res = {}
    for n, kv in ((1, None), (2, mxt.kv.create("device"))):
        it = mxt.io.NDArrayIter(x, y, batch_size=BATCH)
        mod = mxt.mod.Module(_net(mxt), context=_contexts(mxt, n))
        mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
                optimizer_params=SGD,
                arg_params={k: mxt.nd.array(v, mxt.cpu())
                            for k, v in _weights().items()},
                aux_params={"bn_moving_mean": mxt.nd.zeros((4,), mxt.cpu()),
                            "bn_moving_var": mxt.nd.ones((4,), mxt.cpu())})
        args, auxs = mod.get_params()
        res[n] = ({k: v.asnumpy() for k, v in {**args, **auxs}.items()},
                  dict(mod.score(it, "acc"))["accuracy"])
    for k in res[1][0]:
        np.testing.assert_allclose(res[2][0][k], res[1][0][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert res[2][1] == res[1][1]
