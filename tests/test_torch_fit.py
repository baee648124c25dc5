"""The training loop against the JAX package on the CPU: ResNet-8 at 16 px
through both packages' ``Module`` (three steps by hand, then ``fit`` for two
epochs, ``score`` and ``predict``), the metrics, the learning-rate
schedules, ``NDArrayIter``, the callbacks, checkpoints written by one
package and read by the other, optimizer states in checkpoints, ``fit``'s
checkpoints and resume (an interrupted run resumed equals the uninterrupted
one), the ``fit`` options that are not ported, ``examples/train_cifar10.py``
and ``examples/image_classification/train_imagenet.py`` on the CPU.
Weights, batches and predictions are made with numpy and fed to both
packages.

The reference runs as in ``test_torch_module.py`` (``MXNET_GRAPHOPT=0``,
``MXTPU_FUSED_GRADS=1``, no parameter donation). Where an fp32 training run
is compared, it runs op by op on the port's ReLU masks
(:class:`SharedReluMasks`). ``PYTHONPATH=. python tests/test_torch_fit.py``
prints the gaps that the limits were set from."""
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu import ops as jops
from mxnet_tpu_torch import ops as tops

STEPS, BATCH, PX, CLASSES = 3, 8, 16, 10
# fp32, op by op on shared masks: weights after 3 steps 3.5e-7 of max-abs
# and aux 7.4e-7, held to the issue's 1e-4 and 1e-5. bf16 (the reference
# jitted, its own masks): weights 4.8e-2 off the reference's bf16 and 9.2e-2
# off its fp32 run (the reference's own bf16 run: 8.7e-2), aux 3.5e-2; both
# packages round every op to bf16 and BatchNorm magnifies it, and a bf16
# ReLU input flips with the rounding (621 units in 3 steps). bf16 limits:
# twice the readings, and no further from the fp32 run than the reference's
# bf16 run plus 2e-2.
LIMITS = {None: dict(w=1e-4, aux=1e-5),
          "bfloat16": dict(w=0.1, aux=7e-2, w_fp32_over_reference=2e-2)}
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs: the tier-1 run puts six test
    workers on the host's cores, and thread pools of one thread a core in
    each oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)
    monkeypatch.delenv("MXNET_RUN_N_STEPS", raising=False)
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class SharedReluMasks:
    """The port's ReLUs record their masks (which inputs are positive), in
    the order they run; the reference, run op by op under
    ``jax.disable_jit()`` (its jitted step would keep the masks of its first
    trace), then takes those masks in the same order. Two frameworks round
    differently, so after an update an input within rounding of 0 can take
    another sign in each, pass its gradient in one only, and move a weight
    by far more than rounding: against the jitted reference the fp32
    weights of ResNet-8 part by 7.9e-4 of max-abs after three steps at seed
    0. With one set of masks both packages differentiate one function.
    ``flips`` counts the units whose mask the reference's own inputs would
    have set otherwise."""

    def __init__(self, monkeypatch):
        self.masks, self.used, self.flips = [], 0, 0
        self.replaying = False
        t_act, j_act = tops.get_op("Activation"), jops.get_op("Activation")
        t_fn, j_fn = t_act.fn, j_act.fn

        def t_record(ctx, attrs, data):
            if attrs.get("act_type", "relu") == "relu" \
                    and data.device.type != "meta":
                self.masks.append((data.detach() > 0).numpy())
            return t_fn(ctx, attrs, data)

        def j_replay(ctx, attrs, data):
            primal = data
            while hasattr(primal, "primal"):   # under jax.vjp
                primal = primal.primal
            if attrs.get("act_type", "relu") != "relu" or not self.replaying \
                    or isinstance(primal, jax.core.Tracer):  # shape inference
                return j_fn(ctx, attrs, data)
            mask = self.masks[self.used]
            self.used += 1
            assert mask.shape == data.shape
            self.flips += int((np.asarray(primal > 0) != mask).sum())
            return jnp.where(mask, data, jnp.zeros((), data.dtype))

        monkeypatch.setattr(t_act, "fn", t_record)
        monkeypatch.setattr(j_act, "fn", j_replay)

    def replay(self, fn, *args, **kwargs):
        """``fn`` of the reference, op by op, on the recorded masks."""
        self.replaying = True
        try:
            with jax.disable_jit():
                return fn(*args, **kwargs)
        finally:
            self.replaying = False

    def all_used(self):
        return self.used == len(self.masks) > 0


def resnet8(pkg):
    return pkg.models.resnet.get_symbol(CLASSES, 8, f"3,{PX},{PX}")


def resnet8_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, PX, PX)).astype(np.float32)
    y = rng.integers(0, CLASSES, n).astype(np.float32)
    return x, y


def resnet8_params(seed=0):
    """Random weights and aux states, as numpy, by name."""
    rng = np.random.default_rng(seed)
    sym = resnet8(mxt)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(BATCH, 3, PX, PX), softmax_label=(BATCH,))
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        fan_in = np.prod(s[1:]) if len(s) > 1 else 1
        args[n] = (rng.standard_normal(s) / np.sqrt(fan_in)).astype(
            np.float32) + (1.0 if n.endswith("_gamma") else 0.0)
    aux = {n: (np.abs(rng.standard_normal(s)) + 0.5 if n.endswith("_var")
               else rng.standard_normal(s) * 0.1).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _nd(pkg, arrays):
    return {n: pkg.nd.array(a, pkg.cpu()) for n, a in arrays.items()}


def _numpy(params):
    return {n: a.asnumpy() for n, a in params.items()}


def _bound(pkg, amp=None, for_training=True):
    args, aux = resnet8_params()
    mod = pkg.mod.Module(resnet8(pkg), context=pkg.cpu(), amp=amp)
    mod.bind(data_shapes=[("data", (BATCH, 3, PX, PX))],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=for_training)
    mod.init_params(arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux))
    return mod


# ---------------------------------------------------------------------------
# three steps by hand


def _module_steps(pkg, amp):
    mod = _bound(pkg, amp)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    x, y = resnet8_data(STEPS * BATCH)
    for i in range(STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        mod.forward_backward(pkg.io.DataBatch(
            data=[pkg.nd.array(x[sl], pkg.cpu())],
            label=[pkg.nd.array(y[sl], pkg.cpu())]))
        mod.update()
    arg_params, aux_params = mod.get_params()
    return _numpy(arg_params), _numpy(aux_params)


def module_gaps(amp, masks=None):
    """Gaps after three steps: fp32 with the reference op by op on the
    port's masks, bf16 against the jitted reference and its fp32 run."""
    args, _ = resnet8_params()
    t_w, t_aux = _module_steps(mxt, amp)
    if masks is not None:
        j_w, j_aux = masks.replay(_module_steps, mxj, amp)
        assert masks.all_used()
    else:
        j_w, j_aux = _module_steps(mxj, amp)
    gaps = {"w": max(rel_err(t_w[n], j_w[n]) for n in j_w),
            "aux": max(rel_err(t_aux[n], j_aux[n]) for n in j_aux),
            "moved": min(np.abs(t_w[n] - args[n]).max() for n in j_w)}
    if masks is not None:
        gaps["relu_masks_differ"] = masks.flips
    if amp is not None:
        e_w, _ = _module_steps(mxj, None)
        gaps["w_fp32"] = max(rel_err(t_w[n], e_w[n]) for n in e_w)
        gaps["reference_w_fp32"] = max(rel_err(j_w[n], e_w[n]) for n in e_w)
    return gaps


def test_resnet8_module_steps_match_reference_fp32(monkeypatch):
    """Three SGD-momentum steps of ResNet-8 at 16 px in fp32: identical
    weights, aux, batches and ReLU masks; every weight and moving statistic
    after them."""
    gaps = module_gaps(None, SharedReluMasks(monkeypatch))
    lim = LIMITS[None]
    assert gaps["w"] <= lim["w"] and gaps["aux"] <= lim["aux"], gaps
    assert gaps["moved"] > 0, gaps


def test_resnet8_module_steps_match_reference_bf16():
    """The same three steps under bf16 amp."""
    gaps = module_gaps("bfloat16")
    lim = LIMITS["bfloat16"]
    assert gaps["w"] <= lim["w"] and gaps["aux"] <= lim["aux"], gaps
    assert gaps["w_fp32"] <= gaps["reference_w_fp32"] \
        + lim["w_fp32_over_reference"], gaps


# ---------------------------------------------------------------------------
# fit, score and predict


def _fit(pkg, n_train=5 * BATCH, n_val=2 * BATCH + 3):
    """fit for two epochs (no shuffle, a padded last validation batch);
    per-batch train metrics and per-epoch validation metrics."""
    x, y = resnet8_data(n_train + n_val, seed=2)
    train = pkg.io.NDArrayIter(x[:n_train], y[:n_train], batch_size=BATCH)
    val = pkg.io.NDArrayIter(x[n_train:], y[n_train:], batch_size=BATCH)
    args, aux = resnet8_params()
    mod = pkg.mod.Module(resnet8(pkg), context=pkg.cpu())
    train_log, val_log, epochs = [], [], []
    mod.fit(train, eval_data=val, eval_metric=["acc", "ce"], num_epoch=2,
            optimizer="sgd", optimizer_params=SGD,
            arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
            batch_end_callback=lambda p: train_log.append(
                p.eval_metric.get_name_value()),
            eval_end_callback=lambda p: val_log.append(
                p.eval_metric.get_name_value()),
            epoch_end_callback=lambda e, s, a, x: epochs.append(e))
    arg_params, aux_params = mod.get_params()
    return (_numpy(arg_params), _numpy(aux_params), train_log, val_log,
            epochs)


def test_fit_matches_reference(monkeypatch):
    """Two epochs of ``fit`` from identical weights and aux, op by op on
    shared masks in the reference: the weights and aux after it, the
    training metrics after every batch and the validation metrics after
    every epoch."""
    masks = SharedReluMasks(monkeypatch)
    t_w, t_aux, t_train, t_val, t_epochs = _fit(mxt)
    j_w, j_aux, j_train, j_val, j_epochs = masks.replay(_fit, mxj)
    assert masks.all_used() and t_epochs == j_epochs == [0, 1]
    assert max(rel_err(t_w[n], j_w[n]) for n in j_w) <= LIMITS[None]["w"]
    assert max(rel_err(t_aux[n], j_aux[n]) for n in j_aux) \
        <= LIMITS[None]["aux"]
    assert len(t_train) == len(j_train) == 10 and len(t_val) == 2
    for got, want in zip(t_train + t_val, j_train + j_val):
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=1e-5, atol=1e-5)


def test_score_and_predict_match_reference():
    """``score`` (accuracy, cross-entropy, top-3) and ``predict`` (a padded
    last batch dropped) through the evaluation forward, whose BatchNorms
    read the moving statistics."""
    x, y = resnet8_data(2 * BATCH + 3, seed=3)
    got = {}
    for pkg in (mxt, mxj):
        mod = _bound(pkg, for_training=False)
        it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
        score = mod.score(it, ["acc", "ce", pkg.metric.create(
            "top_k_accuracy", top_k=3)])
        preds = mod.predict(it).asnumpy()
        batches = [(o[0].asnumpy(), n, b.pad)
                   for o, n, b in mod.iter_predict(it)]
        got[pkg] = score, preds, batches
    (t_score, t_pred, t_it), (j_score, j_pred, j_it) = got[mxt], got[mxj]
    assert [n for n, _ in t_score] == [n for n, _ in j_score]
    np.testing.assert_allclose([v for _, v in t_score],
                               [v for _, v in j_score], rtol=1e-5)
    assert t_pred.shape == j_pred.shape == (2 * BATCH + 3, CLASSES)
    assert rel_err(t_pred, j_pred) <= 1e-5
    assert [(o.shape, n, p) for o, n, p in t_it] \
        == [(o.shape, n, p) for o, n, p in j_it] \
        == [((8, 10), 0, 0), ((8, 10), 1, 0), ((3, 10), 2, 5)]
    assert rel_err(np.concatenate([o for o, _, _ in t_it]), t_pred) == 0


@pytest.mark.parametrize("option", [
    dict(monitor=True),
    {"MXNET_RUN_N_STEPS": "2", "MXNET_RUN_N_STEPS_UNROLL": "4"}],
    ids=lambda o: list(o)[0])
def test_fit_refuses_unported_options(option, monkeypatch):
    """Each option of the reference's ``fit`` that is not ported raises
    and names itself; none is ignored. ``MXNET_RUN_N_STEPS`` runs through
    ``run_n_steps``; its one graph of n steps (an integer
    ``MXNET_RUN_N_STEPS_UNROLL``) is not ported."""
    kwargs = {}
    for k, v in option.items():
        if k.startswith("MXNET_"):
            monkeypatch.setenv(k, v)
        else:
            kwargs[k] = v
    x, y = resnet8_data(BATCH)
    mod = mxt.mod.Module(resnet8(mxt), context=mxt.cpu())
    with pytest.raises(mxt.MXNetError, match=list(option)[0]):
        mod.fit(mxt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                **kwargs)
    assert not mod.binded


@pytest.mark.parametrize("option", [
    dict(checkpoint_prefix="ck"),
    dict(checkpoint_prefix="ck", checkpoint_every_n_batches=1),
    dict(checkpoint_prefix="ck", resume=True),
    {"MXNET_DEVICE_PREFETCH": "1"}], ids=lambda o: "-".join(o))
def test_fit_runs_the_ported_options(option, monkeypatch, tmp_path):
    """The options that ``fit`` refused before their ports: checkpoints
    with optimizer states (at each epoch's end and every N batches),
    ``resume`` (a fresh start without a checkpoint) and the device
    prefetch."""
    kwargs = {}
    for k, v in option.items():
        if k.startswith("MXNET_"):
            monkeypatch.setenv(k, v)
        else:
            kwargs[k] = str(tmp_path / v) if k == "checkpoint_prefix" else v
    x, y = resnet8_data(2 * BATCH)
    mod = mxt.mod.Module(resnet8(mxt), context=mxt.cpu())
    mod.fit(mxt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            optimizer_params=SGD, **kwargs)
    if "checkpoint_prefix" in kwargs:
        prefix = kwargs["checkpoint_prefix"]
        assert mxt.model.list_checkpoints(prefix) == [0]
        assert mxt.model.read_manifest(prefix, 0)["batch"] is None
        assert os.path.exists(f"{prefix}-0000.states")
    with pytest.raises(mxt.MXNetError, match="checkpoint_prefix"):
        mod.fit(mxt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
                resume=True)


def test_fit_initializes_moving_statistics():
    """``fit`` from an initializer: gammas 1, betas 0, every moving mean 0
    and moving variance 1 before training (the initializer's name rules),
    then moved by the training forward."""
    x, y = resnet8_data(BATCH)
    mod = mxt.mod.Module(resnet8(mxt), context=mxt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, PX, PX))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mxt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    args, aux = mod.get_params()
    assert all((a.asnumpy() == (n.endswith("_var"))).all()
               for n, a in aux.items())
    assert all((args[n].asnumpy() == 1).all() for n in args
               if n.endswith("_gamma"))
    mod.fit(mxt.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            optimizer_params=SGD)
    _, aux = mod.get_params()
    assert all(np.isfinite(a.asnumpy()).all() and (a.asnumpy() != (
        n.endswith("_var"))).any() for n, a in aux.items())


# ---------------------------------------------------------------------------
# checkpoints


class _Stop(Exception):
    pass


def _resumable_fit(pkg, prefix, stop=None, resume=False, epochs=2):
    """``fit`` of ResNet-8 over 5 batches an epoch, a checkpoint every 2
    batches, stopped by an exception in the batch-end callback after
    ``stop`` = (epoch, batches) when given; the weights, the momenta and the
    (epoch, batch) of each callback."""
    x, y = resnet8_data(5 * BATCH, seed=6)
    args, aux = resnet8_params()
    mod = pkg.mod.Module(resnet8(pkg), context=pkg.cpu())
    seen = []

    def cb(p):
        seen.append((p.epoch, p.nbatch))
        if stop == (p.epoch, p.nbatch + 1):
            raise _Stop()

    try:
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=epochs,
                optimizer="sgd", optimizer_params=SGD,
                arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
                checkpoint_prefix=prefix, checkpoint_every_n_batches=2,
                resume=resume, batch_end_callback=cb)
    except _Stop:
        pass
    arg_params, _ = mod.get_params()
    moms = {mod._param_names[i]: st.asnumpy()
            for i, st in mod._updater.states.items()}
    return _numpy(arg_params), moms, seen


@pytest.mark.parametrize("stop", [(0, 4), (1, 2), (0, 5), (1, 1)])
def test_fit_resume_equals_the_uninterrupted_run(tmp_path, stop):
    """A run stopped after batch 4 of epoch 0 (a checkpoint at batch 4),
    after batch 2 of epoch 1, after the last batch of epoch 0 (before its
    epoch-end checkpoint: batch 5 is trained again from the one at 4) or
    after batch 1 of epoch 1 (back to epoch 0's end), then
    ``resume=True``, against one run of two epochs: the resumed run starts
    at the last checkpoint's epoch and batch, and its weights and momenta
    equal the uninterrupted run's bit for bit."""
    w, m, seen = _resumable_fit(mxt, None)
    prefix = str(tmp_path / "ck")
    _, _, seen1 = _resumable_fit(mxt, prefix, stop=stop)
    epoch, done = stop[0], stop[1] // 2 * 2   # batches in the checkpoint
    manifest = mxt.model.read_manifest(prefix, epoch if done else epoch - 1)
    assert manifest["batch"] == (done or None)
    w2, m2, seen2 = _resumable_fit(mxt, prefix, resume=True)
    assert seen1 == seen[:seen.index((epoch, stop[1] - 1)) + 1]
    assert seen2 == seen[seen.index((epoch, done)):]
    assert set(m) == set(m2) == set(w)
    for n in w:
        np.testing.assert_array_equal(w2[n], w[n], err_msg=n)
        np.testing.assert_array_equal(m2[n], m[n], err_msg=n)


def test_fit_resume_matches_reference(tmp_path, monkeypatch):
    """The same interrupted and resumed run through both packages (the
    reference op by op on the port's ReLU masks): weights and momenta
    within the fp32 limits of ``test_fit_matches_reference``."""
    masks = SharedReluMasks(monkeypatch)
    t_prefix, j_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    _resumable_fit(mxt, t_prefix, stop=(0, 4))
    t_w, t_m, t_seen = _resumable_fit(mxt, t_prefix, resume=True)
    masks.replay(_resumable_fit, mxj, j_prefix, stop=(0, 4))
    j_w, j_m, j_seen = masks.replay(_resumable_fit, mxj, j_prefix,
                                    resume=True)
    assert masks.all_used() and t_seen == j_seen
    assert max(rel_err(t_w[n], j_w[n]) for n in j_w) <= LIMITS[None]["w"]
    assert max(rel_err(t_m[n], j_m[n]) for n in j_m) <= LIMITS[None]["w"]


def test_resume_point_skips_a_corrupt_checkpoint(tmp_path):
    """``find_resume_point`` takes the newest intact checkpoint: a corrupt
    newest one is skipped for the one before; none gives None."""
    prefix = str(tmp_path / "ck")
    assert mxt.model.find_resume_point(prefix) is None
    mod = _bound(mxt)
    mod.save_checkpoint(prefix, 0, batch=3)
    mod.save_checkpoint(prefix, 1)
    got = mxt.model.find_resume_point(prefix, ctx=mxt.cpu())
    assert got[:3] == (2, 0, 1)
    with open(f"{prefix}-0001.params", "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    got = mxt.model.find_resume_point(prefix, ctx=mxt.cpu())
    assert got[:3] == (0, 3, 0)
    ref = mxj.model.find_resume_point(prefix)
    assert ref[:3] == got[:3]
    for n, a in got[4].items():
        np.testing.assert_array_equal(a.asnumpy(), ref[4][n].asnumpy())


@pytest.mark.parametrize("background", [False, True])
def test_optimizer_states_in_checkpoints(tmp_path, background):
    """``save_checkpoint(save_optimizer_states=True)`` (at once or from a
    background thread) and ``Module.load(load_optimizer_states=True)``:
    the loaded module's momenta equal the saved ones, and its next step
    equals the original module's."""
    prefix = str(tmp_path / "ck")
    mod = _bound(mxt)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    x, y = resnet8_data(2 * BATCH, seed=8)
    batches = [mxt.io.DataBatch(data=[mxt.nd.array(x[i:i + BATCH],
                                                   mxt.cpu())],
                                label=[mxt.nd.array(y[i:i + BATCH],
                                                    mxt.cpu())])
               for i in (0, BATCH)]
    mod.forward_backward(batches[0])
    mod.update()
    handle = mod.save_checkpoint(prefix, 1, save_optimizer_states=True,
                                 background=background)
    if background:
        assert handle.wait(timeout=60) and handle.done
    else:
        assert handle is None
    saved = {i: st.asnumpy() for i, st in mod._updater.states.items()}
    loaded = mxt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mxt.cpu())
    loaded.bind(data_shapes=[("data", (BATCH, 3, PX, PX))],
                label_shapes=[("softmax_label", (BATCH,))])
    loaded.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    assert set(loaded._updater.states) == set(saved)
    for i, a in saved.items():
        np.testing.assert_array_equal(np.asarray(loaded._updater.states[i]),
                                      a)
    for m in (mod, loaded):
        m.forward_backward(batches[1])
        m.update()
    for n, a in mod.get_params()[0].items():
        np.testing.assert_array_equal(loaded.get_params()[0][n].asnumpy(),
                                      a.asnumpy())
    with open(f"{prefix}-0001.states", "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(mxt.model.CheckpointCorrupt, match="states"):
        loaded.load_optimizer_states(f"{prefix}-0001.states")


def test_checkpoints_load_in_the_other_package(tmp_path):
    """A checkpoint (symbol, params with arg:/aux: keys, manifest with its
    CRC32) written by either package loads in the other with equal arrays;
    ``Module.load`` binds the port on the checkpoint's parameters."""
    mod = _bound(mxt)
    args, aux = resnet8_params()
    t_prefix, j_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    mod.save_checkpoint(t_prefix, 3)
    mxt.callback.do_checkpoint(t_prefix, period=2)(3, mod.symbol,
                                                    *mod.get_params())
    mxj.model.save_checkpoint(j_prefix, 3, resnet8(mxj), _nd(mxj, args),
                              _nd(mxj, aux))
    assert mxt.model.list_checkpoints(t_prefix) == [3, 4]
    assert mxt.model.read_manifest(t_prefix, 4)["epoch"] == 4
    for loader, prefix in ((mxj.model.load_checkpoint, t_prefix),
                           (mxt.model.load_checkpoint, j_prefix)):
        kw = {} if loader is mxj.model.load_checkpoint else {"ctx":
                                                             mxt.cpu()}
        sym, got_args, got_aux = loader(prefix, 3, **kw)
        assert sym.list_arguments() == resnet8(mxt).list_arguments()
        assert sym.list_auxiliary_states() \
            == resnet8(mxt).list_auxiliary_states()
        for want, got in ((args, got_args), (aux, got_aux)):
            assert set(got) == set(want)
            for n in want:
                np.testing.assert_array_equal(got[n].asnumpy(), want[n])
    loaded = mxt.mod.Module.load(j_prefix, 3, context=mxt.cpu())
    loaded.bind(data_shapes=[("data", (BATCH, 3, PX, PX))],
                label_shapes=[("softmax_label", (BATCH,))])
    for n, a in loaded.get_params()[1].items():
        np.testing.assert_array_equal(a.asnumpy(), aux[n])
    with open(f"{t_prefix}-0003.params", "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff")
    with pytest.raises(mxt.model.CheckpointCorrupt, match="crc32"):
        mxt.model.load_checkpoint(t_prefix, 3, ctx=mxt.cpu())
    with pytest.raises(mxt.MXNetError, match="optimizer states"):
        mod.save_checkpoint(t_prefix, 5, save_optimizer_states=True)


def test_save_params_load_in_the_other_package(tmp_path):
    """``save_params`` of one package, ``load_params`` of the other."""
    t_mod, j_mod = _bound(mxt), _bound(mxj)
    t_mod.save_params(str(tmp_path / "port.params"))
    fresh = mxt.mod.Module(resnet8(mxt), context=mxt.cpu())
    fresh.bind(data_shapes=[("data", (BATCH, 3, PX, PX))],
               label_shapes=[("softmax_label", (BATCH,))])
    fresh.init_params()
    fresh.load_params(str(tmp_path / "port.params"))
    j_mod.load_params(str(tmp_path / "port.params"))
    for got in (fresh.get_params(), j_mod.get_params()):
        for want, have in zip(t_mod.get_params(), got):
            for n, a in want.items():
                np.testing.assert_array_equal(have[n].asnumpy(), a.asnumpy())


def test_convert_carries_aux():
    """The reference's ``get_params()`` as numpy become the port's
    ``(arg, aux)`` NDArrays, moving statistics included."""
    j_args, j_aux = _bound(mxj).get_params()
    args, aux = mxt.convert.params_from_numpy(
        _numpy(j_args), _numpy(j_aux), mxt.cpu())
    mod = _bound(mxt)
    mod.set_params(args, aux)
    for n, a in mod.get_params()[1].items():
        np.testing.assert_array_equal(a.asnumpy(), j_aux[n].asnumpy())


# ---------------------------------------------------------------------------
# metrics, schedules, iterators, callbacks


def _metric_inputs(rng):
    probs = rng.dirichlet(np.ones(5), 12).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.float32)
    binary = rng.dirichlet(np.ones(2), 12).astype(np.float32)
    blabels = rng.integers(0, 2, 12).astype(np.float32)
    reg = rng.standard_normal((12, 1)).astype(np.float32)
    rlabels = rng.standard_normal(12).astype(np.float32)
    nll = rng.random(12).astype(np.float32)
    return probs, labels, binary, blabels, reg, rlabels, nll


def _np_mae(label, pred):
    return float(np.abs(label.ravel() - pred.ravel()).mean())


def _np_hits(label, pred):
    """(hits, count): a feval that returns a sum and its count."""
    return int((pred.argmax(1) == label).sum()), label.size


@pytest.mark.parametrize("name,kwargs,which", [
    ("acc", {}, "cls"), ("top_k_accuracy", {"top_k": 3}, "cls"),
    ("f1", {}, "bin"), ("perplexity", {}, "cls"),
    ("perplexity", {"ignore_label": 2}, "cls"), ("perplexity", {}, "nll"),
    ("mae", {}, "reg"), ("mse", {}, "reg"), ("rmse", {}, "reg"),
    ("ce", {}, "cls"), ("loss", {}, "nll"), ("custom", {}, "reg"),
    ("np", {}, "reg"), ("composite", {}, "cls")])
def test_metrics_match_reference(name, kwargs, which):
    """Every ported metric, on the same predictions and labels, over two
    updates and after a reset."""
    rng = np.random.default_rng(7)
    probs, labels, binary, blabels, reg, rlabels, nll = _metric_inputs(rng)
    preds, labs = {"cls": (probs, labels), "bin": (binary, blabels),
                   "reg": (reg, rlabels), "nll": (nll, labels)}[which]
    values = {}
    for pkg in (mxt, mxj):
        if name == "custom":
            metric = pkg.metric.CustomMetric(_np_mae, name="mae2")
        elif name == "np":
            metric = pkg.metric.np_metric(_np_mae)
        elif name == "composite":
            metric = pkg.metric.create(["acc", "ce", _np_hits])
        else:
            metric = pkg.metric.create(name, **kwargs)
        got = []
        for _ in range(2):
            metric.update([pkg.nd.array(labs, pkg.cpu())],
                          [pkg.nd.array(preds, pkg.cpu())])
            got.append(metric.get_name_value())
        metric.reset()
        got.append(metric.get_name_value())
        values[pkg] = got
    for t, j in zip(values[mxt], values[mxj]):
        assert [n for n, _ in t] == [n for n, _ in j]
        np.testing.assert_allclose([v for _, v in t], [v for _, v in j],
                                   rtol=1e-6, atol=1e-7)


def test_metric_create_refuses_unknown_names():
    with pytest.raises(ValueError, match="Metric must be"):
        mxt.metric.create("no_such_metric")


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                                 stop_factor_lr=0.02),
    lambda pkg: pkg.lr_scheduler.MultiFactorScheduler(step=[4, 9, 10],
                                                      factor=0.1)],
    ids=["factor", "multi_factor"])
@pytest.mark.parametrize("begin", [0, 5])
def test_lr_schedule_matches_reference(make, begin):
    """The learning rate of every update of a few parameters through an
    SGD optimizer with the schedule, from ``begin_num_update``."""
    got = {}
    for pkg in (mxt, mxj):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1,
                                   lr_scheduler=make(pkg),
                                   begin_num_update=begin)
        lrs = []
        for _ in range(8):
            for index in range(3):
                lrs.append(opt._get_lr(index))
                opt._update_count(index)
        got[pkg] = (lrs, opt.num_update)
    assert got[mxt] == got[mxj]
    assert len(set(got[mxt][0])) > 1


def test_sgd_update_reads_the_schedule():
    """One SGD step on one array reads the schedule at ``num_update``:
    the port's weights equal the reference's after 6 steps through a
    schedule that halves the rate every 2 updates."""
    rng = np.random.default_rng(8)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = rng.standard_normal((6, 5)).astype(np.float32)
    got = {}
    for pkg in (mxt, mxj):
        opt = pkg.optimizer.create(
            "sgd", learning_rate=0.5, momentum=0.9,
            lr_scheduler=pkg.lr_scheduler.FactorScheduler(2, 0.5))
        updater = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(w0, pkg.cpu())
        for g in grads:
            updater(0, pkg.nd.array(g, pkg.cpu()), w)
        got[pkg] = w.asnumpy()
    np.testing.assert_allclose(got[mxt], got[mxj], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    """Batches, labels, ``pad`` and descriptors over three epochs of 11
    examples in batches of 4; shuffled from the same ``np.random`` seed."""
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    y = np.arange(11, dtype=np.float32)
    epochs = {}
    for pkg in (mxt, mxj):
        np.random.seed(4)
        it = pkg.io.NDArrayIter({"data": x}, {"softmax_label": y}, 4,
                                shuffle=shuffle, last_batch_handle=handle)
        assert [(d.name, d.shape) for d in it.provide_data] \
            == [("data", (4, 3))]
        assert [(d.name, d.shape) for d in it.provide_label] \
            == [("softmax_label", (4,))]
        got = []
        for _ in range(3):
            got.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                        for b in it])
            it.reset()
        epochs[pkg] = got
    for t_epoch, j_epoch in zip(epochs[mxt], epochs[mxj]):
        assert len(t_epoch) == len(j_epoch)
        for (tx, ty, tp), (jx, jy, jp) in zip(t_epoch, j_epoch):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            assert tp == jp
    b = next(iter(mxt.io.NDArrayIter(x, y, 4)))
    assert b.data[0].context == mxt.cpu()


def test_speedometer_logs_on_crossing(caplog, monkeypatch):
    """The Speedometer logs samples/s and the metric (then resets it) when
    ``nbatch`` crosses a multiple of ``frequent``, as the reference's."""
    logs = {}
    for pkg in (mxt, mxj):
        clock = iter(np.arange(0.0, 100.0, 0.5))
        monkeypatch.setattr(pkg.callback.time, "time", lambda: next(clock))
        metric = pkg.metric.create("acc")
        metric.update([pkg.nd.array(np.array([1.0, 0.0]), pkg.cpu())],
                      [pkg.nd.array(np.array([[0.2, 0.8], [0.9, 0.1]]),
                                    pkg.cpu())])
        meter = pkg.callback.Speedometer(batch_size=16, frequent=3)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for nbatch in range(8):
                meter(pkg.callback.BatchEndParam(epoch=1, nbatch=nbatch,
                                                 eval_metric=metric,
                                                 locals=None))
        logs[pkg] = [r.getMessage() for r in caplog.records
                     if "Speed" in r.getMessage()]
    assert logs[mxt] == logs[mxj] and len(logs[mxt]) == 2, logs
    assert "Speed: 96.00 samples/sec\tTrain-accuracy=1.000000" in logs[mxt][0]


def test_train_cifar10_example_on_cpu():
    """The example runs on the CPU when asked, and in 2 epochs of 512
    examples its validation accuracy rises above chance (the 8-epoch
    gate of 0.9 runs on the card)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one thread: beside the other test workers, a process that spreads
    # torch's thread pool over every core slows all of them down
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.train_cifar10",
         "--cpu", "--num-epochs", "2", "--num-examples", "512",
         "--batch-size", "32"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    acc = [float(line.split("accuracy ")[1].split()[0])
           for line in out.stdout.splitlines() if "final validation" in line]
    assert len(acc) == 1 and acc[0] > 0.2, out.stdout + out.stderr[-2000:]
    assert "Validation-accuracy" in out.stderr


def _tiny_recs(tmp_path, n_train=48, n_val=16, px=40):
    """Train and validation records of 4 class prototypes at ``px``,
    packed with the port's ``im2rec.py`` from image files."""
    from PIL import Image

    from mxnet_tpu_torch.tools import im2rec

    rng = np.random.default_rng(9)
    protos = rng.integers(0, 256, (4, 2, 2, 3), dtype=np.uint8)
    paths = {}
    for split, n in (("train", n_train), ("val", n_val)):
        root = tmp_path / split
        lines = []
        for i in range(n):
            label = i % 4
            img = np.asarray(Image.fromarray(protos[label]).resize(
                (px, px), Image.BILINEAR), np.float32)
            img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255)
            os.makedirs(root, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(root / f"{i}.jpg",
                                                       quality=95)
            lines.append(f"{i}\t{label}\t{i}.jpg\n")
        prefix = str(tmp_path / split)
        with open(prefix + ".lst", "w") as f:
            f.writelines(lines)
        im2rec.main([prefix, str(root), "--pass-through"])
        paths[split] = prefix + ".rec"
    return paths


def test_train_imagenet_example_on_cpu(tmp_path, caplog):
    """``train_imagenet.py --cpu`` end to end on a tiny ``.rec``: ResNet-8
    at 32 px for 2 epochs with validation and checkpoints, ``--load-epoch``
    resuming from them, and the ``--test-io`` pass."""
    from mxnet_tpu_torch.examples.image_classification import train_imagenet

    recs = _tiny_recs(tmp_path)
    argv = ["--cpu", "--network", "resnet", "--num-layers", "8",
            "--image-shape", "3,32,32", "--num-classes", "4",
            "--num-examples", "48", "--batch-size", "8", "--lr", "0.05",
            "--dtype", "float32", "--disp-batches", "2",
            "--data-train", recs["train"], "--data-val", recs["val"],
            "--model-prefix", str(tmp_path / "model" / "r8")]
    caplog.set_level(logging.INFO)
    mod = train_imagenet.main(argv + ["--num-epochs", "2"])
    assert mod.binded and mod._context == [mxt.cpu()]
    assert mxt.model.list_checkpoints(str(tmp_path / "model" / "r8")) \
        == [1, 2]
    assert sum("Validation-accuracy" in r.getMessage()
               for r in caplog.records) == 2
    val = mxt.image.ImageIter(8, (3, 32, 32), path_imgrec=recs["val"])
    acc = dict(mod.score(val, "acc"))["accuracy"]
    assert 0.0 <= acc <= 1.0
    again = train_imagenet.main(argv + ["--num-epochs", "3",
                                        "--load-epoch", "2"])
    assert mxt.model.list_checkpoints(str(tmp_path / "model" / "r8")) \
        == [1, 2, 3]
    assert again.binded
    n, secs = train_imagenet.main(argv + ["--test-io", "1"])
    assert n == 48 and secs > 0


if __name__ == "__main__":
    os.environ.update(MXNET_GRAPHOPT="0", MXTPU_FUSED_GRADS="1")
    os.environ.pop("MXTPU_DONATE_PARAMS", None)
    _mp = pytest.MonkeyPatch()
    print("fp32, op by op on shared masks:",
          module_gaps(None, SharedReluMasks(_mp)))
    _mp.undo()
    print("fp32, the jitted reference:", module_gaps(None))
    print("bf16:", module_gaps("bfloat16"))
