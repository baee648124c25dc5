"""The fused training step of the port's ``Module`` on the CPU, held to the
JAX package's fused step (tests/test_fused_step.py's cases): forward,
backward and the optimizer's update in one function, the same weights as
the reference's fused step and as the port's split path (rtol 2e-4, atol
2e-5: the reference's fused-vs-split limits), gradients elided unless
``MXTPU_FUSED_GRADS=1``, the staged update surviving an evaluation
forward, rebinds, update counts, donation (``MXTPU_DONATE_PARAMS`` and
``fit``), the eligibility rules, BatchNorm's aux states, and Dropout's
masks. Both packages get the same numpy weights, never seeds. On the CPU
the step runs eagerly; tests/test_torch_cuda_graph.py holds its captured
form on the card."""
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.module.step_graph import capture_refusal

RTOL, ATOL = 2e-4, 2e-5   # tests/test_fused_step.py:55-58
BATCH = 32


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    for k in ("MXTPU_NO_FUSED_STEP", "MXTPU_FUSED_GRADS",
              "MXTPU_DONATE_PARAMS", "MXNET_RUN_N_STEPS",
              "MXNET_DEVICE_PREFETCH"):
        monkeypatch.delenv(k, raising=False)


def _data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    proto = rng.randn(4, 1, 8, 8).astype(np.float32)
    y = rng.randint(0, 4, n)
    x = proto[y] + rng.randn(n, 1, 8, 8).astype(np.float32) * 0.2
    return x, y.astype(np.float32)


def _net(pkg, bn=False, dropout=False):
    d = pkg.sym.Variable("data")
    f = pkg.sym.Flatten(d)
    fc = pkg.sym.FullyConnected(f, num_hidden=16, name="fc1")
    if bn:
        fc = pkg.sym.BatchNorm(fc, fix_gamma=False, name="bn")
    a = pkg.sym.Activation(fc, act_type="relu")
    if dropout:
        a = pkg.sym.Dropout(a, p=0.4, name="drop")
    fc2 = pkg.sym.FullyConnected(a, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _weights(bn=False, seed=3):
    rng = np.random.RandomState(seed)
    w = {"fc1_weight": rng.randn(16, 64) * 0.2, "fc1_bias": rng.randn(16) * 0.1,
         "fc2_weight": rng.randn(4, 16) * 0.3, "fc2_bias": rng.randn(4) * 0.1}
    aux = {}
    if bn:
        w.update(bn_gamma=1 + 0.1 * rng.randn(16), bn_beta=0.1 * rng.randn(16))
        aux = {"bn_moving_mean": 0.1 * rng.randn(16),
               "bn_moving_var": 1 + 0.1 * np.abs(rng.randn(16))}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return f32(w), f32(aux)


def _nd(pkg, arrays):
    if pkg is mxt:
        return {k: mxt.nd.array(v, mxt.cpu()) for k, v in arrays.items()}
    return {k: mxj.nd.array(v) for k, v in arrays.items()}


def _fit(pkg, opt_name="sgd", epochs=2, bn=False, **opt_params):
    x, y = _data()
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = pkg.mod.Module(_net(pkg, bn), context=pkg.cpu())
    args, aux = _weights(bn)
    mod.fit(it, optimizer=opt_name, optimizer_params=opt_params,
            arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
            num_epoch=epochs)
    args, aux = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in {**args, **aux}.items()}


def _bound(pkg, bn=False, dropout=False, batch=BATCH, opt="sgd",
           **opt_params):
    x, y = _data(batch)
    mod = pkg.mod.Module(_net(pkg, bn, dropout), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
             label_shapes=[("softmax_label", (batch,))])
    args, aux = _weights(bn)
    mod.init_params(arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux))
    mod.init_optimizer(optimizer=opt,
                       optimizer_params=opt_params or {"learning_rate": 0.1})
    arr = (lambda a: mxt.nd.array(a, mxt.cpu())) if pkg is mxt \
        else mxj.nd.array
    return mod, pkg.io.DataBatch(data=[arr(x)], label=[arr(y)])


@pytest.mark.parametrize("opt_name,params", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
], ids=["sgd", "adam"])
def test_fused_matches_reference_and_split(opt_name, params, monkeypatch):
    """Two epochs of fit: the port's fused step against the reference's
    fused step and against the port's split path."""
    tmod, fused = _fit(mxt, opt_name, **params)
    assert tmod._fused_step_fn is not None
    _, ref = _fit(mxj, opt_name, **params)
    monkeypatch.setenv("MXTPU_NO_FUSED_STEP", "1")
    smod, split = _fit(mxt, opt_name, **params)
    assert smod._fused_step_fn is None
    for k in ref:
        np.testing.assert_allclose(fused[k], ref[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fused[k], split[k], rtol=RTOL, atol=ATOL)


def test_fused_batchnorm_aux_matches_reference():
    """BatchNorm's moving statistics install at the fused forward, as the
    reference's do; two epochs against the reference's fused step."""
    _, got = _fit(mxt, "sgd", bn=True, learning_rate=0.05, momentum=0.9)
    _, ref = _fit(mxj, "sgd", bn=True, learning_rate=0.05, momentum=0.9)
    assert {"bn_moving_mean", "bn_moving_var"} <= set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL)


def test_grads_elided_by_default():
    mod, batch = _bound(mxt)
    assert mod._fused_step_fn is not None and not mod._fused_want_grads
    mod.forward(batch, is_train=True)
    mod.backward()   # writes nothing, raises nothing
    with pytest.raises(mxt.MXNetError, match="MXTPU_FUSED_GRADS"):
        mod._exec_group.get_grads()
    mod.update()


def test_grads_visible_after_backward_when_opted_in(monkeypatch):
    """MXTPU_FUSED_GRADS=1: backward() writes the step's gradients, the
    reference's (same weights, same batch)."""
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    got = {}
    for pkg in (mxt, mxj):
        mod, batch = _bound(pkg)
        assert mod._fused_step_fn is not None and mod._fused_want_grads
        mod.forward(batch, is_train=True)
        mod.backward()
        got[pkg] = {k: g.asnumpy()
                    for k, g in mod._exec_group.get_grads().items()}
    assert any(np.abs(g).sum() > 0 for g in got[mxt].values())
    for k in got[mxj]:
        np.testing.assert_allclose(got[mxt][k], got[mxj][k], rtol=RTOL,
                                   atol=ATOL)


def test_eval_forward_keeps_staged_update():
    mod, batch = _bound(mxt)
    w0 = mod._exec_group._executor.arg_dict["fc1_weight"].asnumpy()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.forward(batch, is_train=False)   # mid-loop validation
    # the staged weights are not installed before update()
    np.testing.assert_array_equal(
        mod._exec_group._executor.arg_dict["fc1_weight"].asnumpy(), w0)
    mod.update()
    w1 = mod._exec_group._executor.arg_dict["fc1_weight"].asnumpy()
    assert np.abs(w1 - w0).sum() > 0, "staged update was lost"


def test_new_train_forward_drops_staged_update():
    """A second train forward without update() runs from the weights
    before the first: the first step's staged update is dropped, as in the
    reference."""
    got = {}
    for pkg in (mxt, mxj):
        mod, batch = _bound(pkg)
        mod.forward(batch, is_train=True)
        mod.forward(batch, is_train=True)
        mod.update()
        assert mod._optimizer.num_update == 1
        got[pkg] = mod.get_params()[0]["fc1_weight"].asnumpy()
    np.testing.assert_allclose(got[mxt], got[mxj], rtol=RTOL, atol=ATOL)


def test_rebind_rebuilds_fused_step():
    mod, batch = _bound(mxt)
    fn0 = mod._fused_step_fn
    assert fn0 is not None
    mod.bind(data_shapes=[("data", (16, 1, 8, 8))],
             label_shapes=[("softmax_label", (16,))], force_rebind=True)
    assert mod._fused_step_fn is not None and mod._fused_step_fn is not fn0
    x, y = _data(16, seed=3)
    b2 = mxt.io.DataBatch(data=[mxt.nd.array(x, mxt.cpu())],
                          label=[mxt.nd.array(y, mxt.cpu())])
    mod.forward(b2, is_train=True)
    mod.backward()
    mod.update()
    assert mod.get_outputs()[0].shape == (16, 4)


def test_update_counts_advance_once_per_update():
    mod, batch = _bound(mxt)
    for _ in range(3):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    assert mod._optimizer.num_update == 3
    assert mod.step_info()["eager_runs"] == 3


def test_donate_params_matches_staged(monkeypatch):
    """MXTPU_DONATE_PARAMS=1 (the weights written during the step) gives
    the staged mode's weights over a fit run."""
    _, staged = _fit(mxt, "adam", learning_rate=1e-3)
    monkeypatch.setenv("MXTPU_DONATE_PARAMS", "1")
    mod, donated = _fit(mxt, "adam", learning_rate=1e-3)
    for k in staged:
        np.testing.assert_allclose(donated[k], staged[k], rtol=1e-6,
                                   atol=1e-7)


def test_donate_params_rejects_explicit_out_grads(monkeypatch):
    monkeypatch.setenv("MXTPU_DONATE_PARAMS", "1")
    mod, batch = _bound(mxt)
    assert mod._fused_donate_params
    mod.forward(batch, is_train=True)
    with pytest.raises(mxt.MXNetError, match="DONATE_PARAMS"):
        mod.backward([mxt.nd.ones((BATCH, 4), mxt.cpu())])


def test_explicit_out_grads_drop_the_staged_update(monkeypatch):
    """Without donation, backward(out_grads) drops the staged step and
    differentiates the forward the caller saw (BatchNorm's aux states
    before it) with those head gradients: the reference's gradients."""
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    head = np.random.RandomState(4).randn(BATCH, 4).astype(np.float32)
    got = {}
    for pkg in (mxt, mxj):
        mod, batch = _bound(pkg, bn=True)
        mod.forward(batch, is_train=True)
        arr = mxt.nd.array(head, mxt.cpu()) if pkg is mxt \
            else mxj.nd.array(head)
        mod.backward([arr])
        assert mod._fused_pending is None
        got[pkg] = {k: g.asnumpy()
                    for k, g in mod._exec_group.get_grads().items()}
        mod.update()
    for k in got[mxj]:
        np.testing.assert_allclose(got[mxt][k], got[mxj][k], rtol=RTOL,
                                   atol=ATOL)


def test_fit_enables_donation(monkeypatch):
    """fit turns donation on for its duration (MXTPU_DONATE_PARAMS=0 keeps
    it off); the staged mode returns after fit."""
    x, y = _data(64)
    seen = []
    mod = mxt.mod.Module(_net(mxt), context=mxt.cpu())
    mod.fit(mxt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
            optimizer_params={"learning_rate": 0.1},
            initializer=mxt.init.Xavier(),
            batch_end_callback=lambda _: seen.append(
                mod._fused_donate_params))
    assert seen and all(seen)
    assert mod._fused_step_fn is not None \
        and mod._fused_donate_params is False
    monkeypatch.setenv("MXTPU_DONATE_PARAMS", "0")
    mod0 = mxt.mod.Module(_net(mxt), context=mxt.cpu())
    during = []
    mod0.fit(mxt.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
             optimizer_params={"learning_rate": 0.1},
             initializer=mxt.init.Xavier(),
             batch_end_callback=lambda _: during.append(
                 mod0._fused_donate_params))
    assert during and not any(during)


@pytest.mark.parametrize("opt", ["sgld", "dcasgd", "rmsprop", "adadelta"])
def test_optimizers_without_a_fused_rule_keep_the_split_path(opt):
    """As in the reference: no ``_tree_update``, no fused step."""
    for pkg in (mxt, mxj):
        mod, batch = _bound(pkg, opt=opt, learning_rate=0.01)
        assert mod._fused_step_fn is None, (pkg.__name__, opt)
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


@pytest.mark.parametrize("opt", ["sgd", "ccsgd", "nag", "adam", "adagrad",
                                 "test"])
def test_optimizers_with_a_fused_rule_match_the_reference(opt):
    """Each fused rule: three steps of the port's fused step against the
    reference's."""
    params = {"learning_rate": 0.05, "wd": 1e-3}
    if opt in ("sgd", "ccsgd", "nag"):
        params["momentum"] = 0.9
    got = {}
    for pkg in (mxt, mxj):
        mod, batch = _bound(pkg, opt=opt, **params)
        assert mod._fused_step_fn is not None
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in got[mxj]:
        np.testing.assert_allclose(got[mxt][k], got[mxj][k], rtol=RTOL,
                                   atol=ATOL)


def test_no_fused_step_env_and_kvstore(monkeypatch):
    monkeypatch.setenv("MXTPU_NO_FUSED_STEP", "1")
    mod, _ = _bound(mxt)
    assert mod._fused_step_fn is None
    monkeypatch.delenv("MXTPU_NO_FUSED_STEP")
    mod._refresh_fused_step()
    assert mod._fused_step_fn is not None
    # a kvstore makes the update non-local
    mod._kvstore = mxt.kv.create("local")
    mod._refresh_fused_step()
    assert mod._fused_step_fn is None


def test_inputs_need_grad_and_add_req_keep_the_split_path():
    for kwargs in (dict(inputs_need_grad=True), dict(grad_req="add")):
        for pkg in (mxt, mxj):
            mod = pkg.mod.Module(_net(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (BATCH, 1, 8, 8))],
                     label_shapes=[("softmax_label", (BATCH,))], **kwargs)
            mod.init_params(pkg.init.Xavier())
            mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
            assert mod._fused_step_fn is None, (pkg.__name__, kwargs)


class _Scale2(mxt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] * 2)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0] * 2)


@mxt.operator.register("fused_step_scale2")
class _Scale2Prop(mxt.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return _Scale2()


def test_custom_node_refuses_the_capture():
    """A Custom node's body is user host code: the step is built, runs
    eagerly, and names the rule."""
    d = mxt.sym.Variable("data")
    f = mxt.sym.Custom(mxt.sym.Flatten(d), op_type="fused_step_scale2",
                       name="scale")
    net = mxt.sym.SoftmaxOutput(mxt.sym.FullyConnected(
        f, num_hidden=4, name="fc2"), name="softmax")
    assert "Custom node 'scale'" in capture_refusal(net)
    assert capture_refusal(_net(mxt)) is None
    mod = mxt.mod.Module(net, context=mxt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 1, 8, 8))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    info = mod.step_info()
    assert not info["captured"] and "Custom" in info["refusal"]
    x, y = _data(BATCH)
    mod.forward(mxt.io.DataBatch(data=[mxt.nd.array(x, mxt.cpu())],
                                 label=[mxt.nd.array(y, mxt.cpu())]),
                is_train=True)
    mod.update()
    assert mod.step_info()["eager_runs"] == 1


def test_dropout_masks_equal_the_split_path(monkeypatch):
    """The step draws Dropout's masks from the same step seeds as the split
    path: from one ``mx.random.seed`` both give the same weights."""
    got = []
    for split in ("", "1"):
        monkeypatch.setenv("MXTPU_NO_FUSED_STEP", split)
        mxt.random.seed(11)
        mod, batch = _bound(mxt, dropout=True)
        assert (mod._fused_step_fn is None) == bool(split)
        outs = []
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        got.append((outs, mod.get_params()[0]))
    (o1, w1), (o2, w2) = got
    for a, b in zip(o1, o2):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for k in w1:
        np.testing.assert_allclose(w1[k].asnumpy(), w2[k].asnumpy(),
                                   rtol=RTOL, atol=ATOL)


def test_load_optimizer_states_rebinds_the_step(tmp_path):
    """Restored optimizer states are new arrays: the step reads them (its
    graph, on the card, is dropped and captured again)."""
    mod, batch = _bound(mxt, opt="sgd", learning_rate=0.1, momentum=0.9)
    for _ in range(2):
        mod.forward(batch, is_train=True)
        mod.update()
    fname = str(tmp_path / "s.states")
    mod.save_optimizer_states(fname)
    w = {k: v.copy() for k, v in mod.get_params()[0].items()}
    mod.forward(batch, is_train=True)
    mod.update()
    want = mod.get_params()[0]["fc1_weight"].asnumpy()
    mod.set_params(w, {})
    mod.load_optimizer_states(fname)
    mod._optimizer.num_update = 2
    mod._optimizer._index_update_count = {i: 2 for i in range(4)}
    mod.forward(batch, is_train=True)
    mod.update()
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_weight"].asnumpy(),
                                  want)


def test_bucketing_module_steps_in_every_bucket_match_split(monkeypatch):
    """Every bucket's module builds its own step (one graph a bucket on the
    card, each with its own pool) over the default bucket's arrays and
    optimizer states; two epochs of fit against the split path."""
    import random

    got = []
    for split in ("", "1"):
        monkeypatch.setenv("MXTPU_NO_FUSED_STEP", split)
        random.seed(0)
        np.random.seed(0)
        mxt.random.seed(0)
        sentences = [list(np.random.randint(1, 32, np.random.choice([4, 8])))
                     for _ in range(64)]
        it = mxt.rnn.BucketSentenceIter(sentences, batch_size=8,
                                        buckets=[4, 8], invalid_label=0)
        mod = mxt.mod.BucketingModule(
            mxt.models.lstm_lm.sym_gen_factory(
                num_hidden=16, num_embed=8, num_layers=1, vocab_size=32),
            default_bucket_key=it.default_bucket_key, context=mxt.cpu())
        mod.fit(it, eval_metric=mxt.metric.Perplexity(0), num_epoch=2,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mxt.init.Xavier())
        infos = mod.step_info()
        assert sorted(infos) == [4, 8]
        if split:
            assert all(i is None for i in infos.values())
        else:
            steps = [m._fused_step_fn for m in mod._buckets.values()]
            assert all(s is not None for s in steps)
            assert len({id(s) for s in steps}) == len(steps)
            assert all(i["eager_runs"] == 0 for i in infos.values()), \
                "fit rebuilt the steps at its end"
            default = mod._buckets[8]
            assert mod._buckets[4]._fused_indices == [
                default._param_index[n]
                for n in mod._buckets[4]._exec_group._executor._diff_args]
        got.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in got[1]:
        np.testing.assert_allclose(got[0][k], got[1][k], rtol=RTOL, atol=ATOL)
