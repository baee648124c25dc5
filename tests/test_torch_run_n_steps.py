"""``Module.run_n_steps`` and ``fit``'s ``MXNET_RUN_N_STEPS`` on the CPU
(tests/test_run_n_steps.py's cases): n fused steps, the one-step function
run on each batch of a super-batch in turn, bit-identical to n single
steps (weights, metric and outputs) with a ``FactorScheduler`` advancing;
the reference's ``run_n_steps`` from the same numpy weights within its
fused-vs-split limits; ``fit``'s super-steps with a short last one, each
batch pulled as it arrives, with ``DevicePrefetchIter``, the callbacks'
cadence and no metric; ``stage_superbatch``; the knobs that are not
ported."""
import os

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.io import DataBatch

RTOL, ATOL = 2e-4, 2e-5   # tests/test_fused_step.py:55-58


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    for k in ("MXTPU_NO_FUSED_STEP", "MXTPU_FUSED_GRADS",
              "MXTPU_DONATE_PARAMS", "MXNET_RUN_N_STEPS",
              "MXNET_RUN_N_STEPS_UNROLL", "MXNET_DEVICE_PREFETCH"):
        monkeypatch.delenv(k, raising=False)


def _data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    proto = rng.randn(4, 1, 8, 8).astype(np.float32)
    y = rng.randint(0, 4, n)
    x = proto[y] + rng.randn(n, 1, 8, 8).astype(np.float32) * 0.2
    return x, y.astype(np.float32)


def _net(pkg):
    d = pkg.sym.Variable("data")
    f = pkg.sym.Flatten(d)
    fc = pkg.sym.FullyConnected(f, num_hidden=16, name="fc1")
    a = pkg.sym.Activation(fc, act_type="relu")
    fc2 = pkg.sym.FullyConnected(a, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _weights(seed=3):
    rng = np.random.RandomState(seed)
    w = {"fc1_weight": rng.randn(16, 64) * 0.2, "fc1_bias": rng.randn(16) * 0.1,
         "fc2_weight": rng.randn(4, 16) * 0.3, "fc2_bias": rng.randn(4) * 0.1}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _arr(pkg, a):
    return mxt.nd.array(a, mxt.cpu()) if pkg is mxt else mxj.nd.array(a)


def _batches(pkg, n_batches, batch=32, seed=0):
    x, y = _data(batch * n_batches, seed)
    return [pkg.io.DataBatch(
        data=[_arr(pkg, x[i * batch:(i + 1) * batch])],
        label=[_arr(pkg, y[i * batch:(i + 1) * batch])])
        for i in range(n_batches)]


def _module(pkg, opt="sgd", sched=False, batch=32, **opt_params):
    mod = pkg.mod.Module(_net(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (batch, 1, 8, 8))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(arg_params={k: _arr(pkg, v)
                                for k, v in _weights().items()})
    params = dict(opt_params)
    if sched:
        params["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
            step=2, factor=0.5)
    mod.init_optimizer(optimizer=opt, optimizer_params=params)
    return mod


def _params(mod):
    args, _ = mod.get_params()
    return [args[k].asnumpy() for k in sorted(args)]


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-3}),   # bias correction a step
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
], ids=["sgd", "adam", "nag"])
def test_run_n_steps_bit_identical(opt, params):
    bs = _batches(mxt, 8)
    m1 = _module(mxt, opt, sched=True, **params)
    metric1 = mxt.metric.create("acc")
    for b in bs:
        m1.forward(b, is_train=True)
        m1.backward()
        m1.update()
        m1.update_metric(metric1, b.label)
    m2 = _module(mxt, opt, sched=True, **params)
    metric2 = mxt.metric.create("acc")
    m2.run_n_steps(bs[:4], eval_metric=metric2)
    m2.run_n_steps(bs[4:], eval_metric=metric2)
    for a, b in zip(_params(m1), _params(m2)):
        assert np.array_equal(a, b), "run_n_steps diverged from single steps"
    assert metric1.get() == metric2.get()
    assert m1._optimizer.num_update == m2._optimizer.num_update == 8
    # the reference's run_n_steps from the same weights
    mj = _module(mxj, opt, sched=True, **params)
    metric_j = mxj.metric.create("acc")
    bj = _batches(mxj, 8)
    mj.run_n_steps(bj[:4], eval_metric=metric_j)
    mj.run_n_steps(bj[4:], eval_metric=metric_j)
    assert mj._optimizer.num_update == 8
    for a, b in zip(_params(m2), _params(mj)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert metric2.get()[1] == pytest.approx(metric_j.get()[1], abs=1 / 256)


def test_run_n_steps_outputs_are_last_step():
    bs = _batches(mxt, 3)
    m1 = _module(mxt)
    for b in bs:
        m1.forward(b, is_train=True)
        m1.backward()
        m1.update()
    ref = [o.asnumpy() for o in m1.get_outputs()]
    m2 = _module(mxt)
    m2.run_n_steps(bs)
    for a, b in zip(ref, [o.asnumpy() for o in m2.get_outputs()]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(mxt.MXNetError, match="MXTPU_FUSED_GRADS"):
        m2._exec_group.get_grads()


def test_run_n_steps_single_batch_degenerates():
    m = _module(mxt)
    m.run_n_steps(_batches(mxt, 1))
    assert m._optimizer.num_update == 1


def test_run_n_steps_requires_fused_step(monkeypatch):
    monkeypatch.setenv("MXTPU_NO_FUSED_STEP", "1")
    m = _module(mxt)
    assert m._fused_step_fn is None
    with pytest.raises(mxt.MXNetError, match="fused"):
        m.run_n_steps(_batches(mxt, 2))


def test_one_graph_of_n_steps_is_not_ported(monkeypatch):
    monkeypatch.setenv("MXNET_RUN_N_STEPS_UNROLL", "4")
    m = _module(mxt)
    with pytest.raises(mxt.MXNetError, match="not ported"):
        m.run_n_steps(_batches(mxt, 4))
    monkeypatch.setenv("MXNET_RUN_N_STEPS_UNROLL", "percall")
    m.run_n_steps(_batches(mxt, 4))
    assert m._optimizer.num_update == 4


def _fit(run_n, n=192, epochs=2, prefetch=False, metric="acc", cbs=None):
    env = {}
    if run_n > 1:
        env["MXNET_RUN_N_STEPS"] = str(run_n)
    if prefetch:
        env["MXNET_DEVICE_PREFETCH"] = "1"
    os.environ.update(env)
    try:
        x, y = _data(n)
        it = mxt.io.NDArrayIter(x, y, batch_size=32)
        mod = mxt.mod.Module(_net(mxt), context=mxt.cpu())
        mod.fit(it, eval_metric=metric, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params={k: _arr(mxt, v) for k, v in _weights().items()},
                num_epoch=epochs, batch_end_callback=cbs)
        return mod
    finally:
        for k in env:
            os.environ.pop(k, None)


def test_fit_superstep_bit_identical_with_partial_tail():
    """190 samples in batches of 32: 6 batches, the last padded; n=4 runs
    one super-step of 4, then the 2-batch tail."""
    for a, b in zip(_params(_fit(1, n=190)), _params(_fit(4, n=190))):
        assert np.array_equal(a, b)


def test_fit_superstep_with_device_prefetch_bit_identical():
    """Through DevicePrefetchIter at its default depth (2): a super-step
    takes each batch as it arrives, so it needs no deeper staging."""
    depths = []
    mod = _fit(4, prefetch=True,
               cbs=lambda p: depths.append(p.locals["train_data"]._depth))
    assert depths and set(depths) == {2}
    for a, b in zip(_params(_fit(1)), _params(mod)):
        assert np.array_equal(a, b)


def test_fit_superstep_callback_cadence():
    """The callbacks come once a super-step, nbatch its last batch."""
    seen = []
    _fit(4, epochs=1, cbs=lambda p: seen.append(p.nbatch))
    assert seen == [3, 5]   # 6 batches: a super-step [0..3], the tail


def test_fit_knob_routes_through_run_n_steps(monkeypatch):
    """fit's super-steps are run_n_steps's: 6 batches at n=3 are two of
    them, and the third finds the epoch's end."""
    calls = []
    orig = mxt.mod.Module._run_steps

    def spy(self, batches, n, eval_metric=None):
        done = orig(self, batches, n, eval_metric=eval_metric)
        calls.append((n, len(done)))
        return done

    monkeypatch.setattr(mxt.mod.Module, "_run_steps", spy)
    _fit(3, epochs=1)
    assert calls == [(3, 3), (3, 3), (3, 0)]
    calls.clear()
    _fit(1, epochs=1)
    assert calls == []


def test_fit_no_metric_skips_bookkeeping(monkeypatch):
    called = []
    monkeypatch.setattr(mxt.mod.Module, "update_metric",
                        lambda self, m, l: called.append(1))
    mod = _fit(4, n=96, epochs=1, metric=None)
    assert not called
    assert all(np.isfinite(w).all() for w in _params(mod))


def test_fit_superstep_metric_equals_single_steps():
    """The metric over super-steps (outputs copied to the host once a
    super-step) equals the single steps' metric."""
    got = []
    for run_n in (1, 3):
        metric = mxt.metric.create("acc")
        _fit(run_n, epochs=1, metric=metric)
        got.append(metric.get())
    assert got[0] == got[1]


def test_stage_superbatch_pull_and_tail():
    x, y = _data(192)
    it = mxt.io.NDArrayIter(x, y, batch_size=32)   # 6 batches
    mod = mxt.mod.Module(_net(mxt), context=mxt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    dp = mod.device_prefetch(it)
    try:
        first = dp.stage_superbatch(4)
        assert len(first) == 4 and all(isinstance(b, DataBatch)
                                       for b in first)
        assert len(dp.stage_superbatch(4)) == 2   # the short last one
        with pytest.raises(StopIteration):
            dp.stage_superbatch(4)
    finally:
        dp.close()


def test_fit_superstep_pulls_each_batch_as_it_arrives():
    """A super-step takes its batches one at a time: the iterator hands
    out batch k once the k steps before it are installed."""
    seen = []

    class Watch(mxt.io.NDArrayIter):
        def next(self):
            batch = super().next()
            seen.append(mod._optimizer.num_update if mod.optimizer_initialized
                        else 0)
            return batch

    x, y = _data(192)
    mod = mxt.mod.Module(_net(mxt), context=mxt.cpu())
    os.environ["MXNET_RUN_N_STEPS"] = "4"
    try:
        mod.fit(Watch(x, y, batch_size=32), optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                arg_params={k: _arr(mxt, v) for k, v in _weights().items()},
                num_epoch=1)
    finally:
        os.environ.pop("MXNET_RUN_N_STEPS")
    assert seen == [0, 1, 2, 3, 4, 5]


def test_run_steps_short_iterator_runs_what_arrives():
    """Fewer batches than planned (an epoch's end): the steps run are the
    single steps', and the counts move by the steps run only."""
    bs = _batches(mxt, 3)
    m1 = _module(mxt, "adam", sched=True, learning_rate=1e-3)
    for b in bs:
        m1.forward(b, is_train=True)
        m1.backward()
        m1.update()
    m2 = _module(mxt, "adam", sched=True, learning_rate=1e-3)
    done = m2._run_steps(iter(bs), 5)
    assert done == bs
    assert m2._optimizer.num_update == 3
    for a, b in zip(_params(m1), _params(m2)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_plan_multi_n_matches_the_reference(opt):
    """The rates of n planned updates, with a stepping schedule and Adam's
    bias correction, equal the reference's and n single plans; the counts
    move only with advance_counts."""
    plans = {}
    for pkg in (mxt, mxj):
        def make():
            # the schedule keeps its own state: one optimizer a plan
            o = pkg.optimizer.create(
                opt, learning_rate=0.1, wd=1e-3,
                lr_scheduler=pkg.lr_scheduler.FactorScheduler(step=2,
                                                              factor=0.5),
                param_idx2name={0: "a_weight", 1: "b_bias"})
            o.set_wd_mult({})
            return o

        o = make()
        lrs, wds = o.plan_multi_n([0, 1], 5)
        assert o.num_update == 0
        single, o1 = [], make()
        for _ in range(5):
            single.append(o1.plan_multi([0, 1]))
            o1.advance_counts([0, 1])
        assert [list(x) for x in lrs] == [list(s[0]) for s in single]
        assert [list(x) for x in wds] == [list(s[1]) for s in single]
        for _ in range(5):
            o.advance_counts([0, 1])
        assert o.num_update == o1.num_update == 5
        plans[pkg] = (lrs, wds)
    assert plans[mxt] == plans[mxj]
