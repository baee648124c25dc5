"""``BucketingModule`` and the LSTM-PTB slice as a whole, the port against
the JAX package on the CPU: 6 training steps over 3 buckets with
SGD-momentum and with Adam, from the same numpy weights and the same
``BucketSentenceIter`` batches (same seeds), give the same weights,
optimizer states and ``Perplexity``; the buckets share one set of arrays
(the same NDArray objects and tensors) and one updater; ``Perplexity``'s
gather on the device equals the host computation; the reference's
convergence gate (``tests/test_lstm_bucketing.py``) passes with both
factories; and ``examples/rnn/lstm_bucketing.py`` runs.

fp32 limits: weights and optimizer states 1e-5 (atol; the gaps read
6e-8 to 2.4e-7 and 3e-8 to 1.2e-7), Perplexity 1e-5 relative (read 0 and
3.7e-8). The reference runs with graph rewrites
off and its gradients readable (``MXNET_GRAPHOPT=0``,
``MXTPU_FUSED_GRADS=1``)."""
import random

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

VOCAB, HIDDEN, EMBED, LAYERS, BATCH = 24, 8, 6, 2, 4
BUCKETS = [4, 6, 8]
STEPS = 6
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 3e-3},
}


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)


def _sentences(n=60, seed=3):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, VOCAB, int(rng.choice([3, 4, 5, 6, 7, 8]))))
            for _ in range(n)]


def _iter(pkg, seed=6):
    random.seed(seed)
    np.random.seed(seed)
    return pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                      invalid_label=0)


def _factory(pkg, fused):
    f = (pkg.models.lstm_lm.fused_sym_gen_factory if fused
         else pkg.models.lstm_lm.sym_gen_factory)
    return f(num_hidden=HIDDEN, num_embed=EMBED, num_layers=LAYERS,
             vocab_size=VOCAB)


def _weights(fused, seed=5):
    sym = _factory(mxt, fused)(max(BUCKETS))[0]
    shapes = {"data": (BATCH, max(BUCKETS)),
              "softmax_label": (BATCH, max(BUCKETS))}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _train(pkg, fused, optimizer, weights):
    it = _iter(pkg)
    mod = pkg.mod.BucketingModule(_factory(pkg, fused),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={n: pkg.nd.array(w, pkg.cpu())
                                for n, w in weights.items()})
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=OPTIMIZERS[optimizer])
    metric = pkg.metric.Perplexity(0)
    keys = []
    for step, batch in enumerate(it):
        if step == STEPS:
            break
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        mod.update_metric(metric, batch.label)
        keys.append(batch.bucket_key)
    arg_params, _ = mod.get_params()
    default = mod._buckets[it.default_bucket_key]
    names = default._param_names
    states = {}
    for i, st in default._updater.states.items():
        leaves = st if isinstance(st, (tuple, list)) else [st]
        states[names[i]] = [np.asarray(leaf.asnumpy()) for leaf in leaves
                            if leaf is not None]
    return ({n: a.asnumpy() for n, a in arg_params.items()}, states,
            metric.get()[1], keys, mod)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_bucketing_steps_match_reference(fused, optimizer):
    weights = _weights(fused)
    got = _train(mxt, fused, optimizer, weights)
    want = _train(mxj, fused, optimizer, weights)
    assert got[3] == want[3] and len(set(got[3])) == 3
    for n in weights:
        np.testing.assert_allclose(got[0][n], want[0][n], rtol=0, atol=1e-5,
                                   err_msg=n)
        assert np.abs(got[0][n] - weights[n]).max() > 0, n  # trained
    assert set(got[1]) == set(want[1]) == set(weights)
    for n in weights:
        for g, w in zip(got[1][n], want[1][n]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=n)
    if not fused:
        # the reference's fused graph pairs each prediction with another
        # position's label in the metric (models/lstm_lm.py)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    assert np.isfinite(got[2])


def test_bucket_modules_share_arrays_and_updater():
    """Every bucket's parameter, gradient and aux arrays are the default
    bucket's NDArray objects (the same tensors: equal ``data_ptr``), its
    parameter dicts and optimizer are the default's, and the updater's
    states stay keyed by the default bucket's indices."""
    weights = _weights(False)
    _, _, _, keys, mod = _train(mxt, False, "sgd", weights)
    default = mod._buckets[max(BUCKETS)]
    d_ex = default._exec_group._executor
    assert sorted(mod._buckets) == BUCKETS
    for key, m in mod._buckets.items():
        ex = m._exec_group._executor
        for n in weights:
            assert ex.arg_dict[n] is d_ex.arg_dict[n]
            assert ex.grad_dict[n] is d_ex.grad_dict[n]
            assert ex.arg_dict[n].data.data_ptr() == \
                d_ex.arg_dict[n].data.data_ptr()
            assert ex.grad_dict[n].data.data_ptr() == \
                d_ex.grad_dict[n].data.data_ptr()
        assert ex.arg_dict["data"].shape == (BATCH, key)
        assert m._arg_params is default._arg_params
        assert m._updater is default._updater
        assert m._param_index == default._param_index
    assert set(default._updater.states) == {
        default._param_index[n] for n in weights}
    assert len(keys) == STEPS


def test_bucketing_module_trains():
    """tests/test_rnn.py test_bucketing_module_trains: two buckets, SGD;
    the parameters are shared NDArray objects."""
    np.random.seed(0)
    vocab = 32
    sentences = [list(np.random.randint(1, vocab,
                                        np.random.choice([4, 8])))
                 for _ in range(64)]
    it = mxt.rnn.BucketSentenceIter(sentences, batch_size=8, buckets=[4, 8],
                                    invalid_label=0)
    sym_gen = mxt.models.lstm_lm.sym_gen_factory(
        num_hidden=16, num_embed=8, num_layers=1, vocab_size=vocab)
    mod = mxt.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  context=mxt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mxt.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    metric = mxt.metric.Perplexity(ignore_label=None)
    for _ in range(2):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
    assert np.isfinite(metric.get()[1])
    assert len(mod._buckets) == 2
    m4 = mod._buckets[4]._exec_group._executor.arg_dict["lstm_l0_i2h_weight"]
    m8 = mod._buckets[8]._exec_group._executor.arg_dict["lstm_l0_i2h_weight"]
    assert m4 is m8


def test_bucketing_module_refusals_and_properties():
    it = _iter(mxt)
    mod = mxt.mod.BucketingModule(_factory(mxt, False),
                                  default_bucket_key=it.default_bucket_key,
                                  context=mxt.cpu())
    assert mod.data_names == ["data"]
    assert mod.output_names == ["softmax_output"]
    with pytest.raises(mxt.MXNetError):
        mod.bind(it.provide_data, it.provide_label,
                 shared_module=mxt.mod.Module(_factory(mxt, False)(4)[0],
                                              context=mxt.cpu()))
    mod.bind(it.provide_data, it.provide_label)
    assert mod.data_shapes[0].shape == (BATCH, max(BUCKETS))
    with pytest.raises(mxt.MXNetError):
        mod.install_monitor(object())
    with pytest.raises(mxt.MXNetError):
        mxt.mod.BucketingModule(_factory(mxt, False))


def test_initializer_rules_for_rnn_arrays():
    """The ``_parameters`` rule draws U(-0.07, 0.07) from ``np.random`` as
    the reference does (the same draws under the same seed); states are
    zero; an unknown name still raises."""
    res = []
    for pkg in (mxt, mxj):
        init = pkg.init.Xavier(factor_type="in", magnitude=2.34)
        arrs = {n: pkg.nd.ones(s, pkg.cpu()) for n, s in (
            ("rnn_parameters", (300,)), ("rnn_state", (2, 3, 4)),
            ("rnn_state_cell", (2, 3, 4)), ("l0_begin_state_1", (3, 4)),
            ("enc_init_h", (3, 4)), ("enc_init_c", (3, 4)))}
        np.random.seed(9)
        for n, a in arrs.items():
            init(n, a)
        res.append({n: a.asnumpy() for n, a in arrs.items()})
        with pytest.raises(Exception, match="Unknown initialization"):
            init("mystery", pkg.nd.ones((2,), pkg.cpu()))
    for n in res[1]:
        np.testing.assert_array_equal(res[0][n], res[1][n])
    assert np.abs(res[0]["rnn_parameters"]).max() <= 0.07
    assert res[0]["rnn_parameters"].std() > 0.03
    assert not res[0]["rnn_state"].any()


@pytest.mark.parametrize("ignore", [None, 0, 3])
def test_perplexity_gather_equals_the_host_computation(ignore):
    """The port gathers each label's probability where the prediction lies
    and copies only those; the value equals the reference's host
    computation over the whole matrix within 1e-6 (relative), negative
    labels included."""
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((6, 40, 50)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(-50, 50, (6, 40)).astype(np.float32)
    labels[0, :5] = 3
    vals = []
    for pkg in (mxt, mxj):
        m = pkg.metric.Perplexity(ignore)
        for b in range(3):
            m.update([pkg.nd.array(labels[2 * b:2 * b + 2], pkg.cpu())],
                     [pkg.nd.array(probs[2 * b:2 * b + 2].reshape(-1, 50),
                                   pkg.cpu())])
        vals.append(m.get()[1])
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-6)
    with pytest.raises(IndexError):
        mxt.metric.Perplexity().update(
            [mxt.nd.array([[50.0]], mxt.cpu())],
            [mxt.nd.array(probs[0, :1], mxt.cpu())])


def _gate_corpus(n_sentences, rng, period=61):
    sents = []
    for _ in range(n_sentences):
        length = int(rng.choice([8, 12, 16]))
        x = int(rng.randint(1, period + 1))
        s = [x]
        for _ in range(length - 1):
            x = (3 * x + 7) % period + 1
            s.append(x)
        sents.append(s)
    return sents


@pytest.mark.parametrize("fused", [False, True])
def test_lstm_bucketing_perplexity_gate(fused):
    """tests/test_lstm_bucketing.py's gate through the port (vocab 64,
    buckets 8/12/16, 1 layer, hidden 64, embed 32, Adam 3e-3, 8 epochs):
    validation perplexity below 6 with both factories."""
    rng = np.random.RandomState(7)
    train, val = _gate_corpus(600, rng), _gate_corpus(100, rng)
    data_train = mxt.rnn.BucketSentenceIter(train, 32, buckets=[8, 12, 16],
                                            invalid_label=0)
    data_val = mxt.rnn.BucketSentenceIter(val, 32, buckets=[8, 12, 16],
                                          invalid_label=0)
    factory = (mxt.models.lstm_lm.fused_sym_gen_factory if fused
               else mxt.models.lstm_lm.sym_gen_factory)
    model = mxt.mod.BucketingModule(
        sym_gen=factory(num_hidden=64, num_embed=32, num_layers=1,
                        vocab_size=64),
        default_bucket_key=data_train.default_bucket_key, context=mxt.cpu())
    mxt.random.seed(0)
    np.random.seed(0)
    model.fit(train_data=data_train, eval_data=data_val,
              eval_metric=mxt.metric.Perplexity(0), optimizer="adam",
              optimizer_params={"learning_rate": 3e-3},
              initializer=mxt.init.Xavier(factor_type="in", magnitude=2.34),
              num_epoch=8)
    ppl = dict(model.score(data_val, mxt.metric.Perplexity(0)))["Perplexity"]
    assert np.isfinite(ppl) and ppl < 6.0, ppl


@pytest.mark.parametrize("fused", ["0", "1"])
def test_lstm_bucketing_example_on_cpu(fused):
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing

    seen = []
    model, data_train, _ = lstm_bucketing.main(
        ["--cpu", "--fused-rnn", fused, "--num-epochs", "1",
         "--num-sentences", "400", "--num-hidden", "16", "--num-embed", "8",
         "--vocab-size", "50", "--seed", "1"],
        batch_end_callback=[lambda p: seen.append(
            (p.nbatch, p.locals["data_batch"].bucket_key))])
    assert len(seen) == len(data_train.idx) > 6
    assert sorted({k for _, k in seen}) == lstm_bucketing.BUCKETS
    assert sorted(model._buckets) == lstm_bucketing.BUCKETS
