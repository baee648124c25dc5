"""The training slice as a whole: the port's ``Module`` against the JAX
package's ``Module`` on the transformer LM, identical numpy weights and
batches, dense and fused heads, fp32 and bf16 amp, Adam. Compared: the
first step's outputs and gradients, and the weights after 3 updates. Also
the Module's plumbing (parameters in and out, fixed parameters, input
gradients, the default device) and the training example at a few steps.

The reference runs on the CPU as its own tests do: graph rewrites off
(``MXNET_GRAPHOPT=0``), attention through its Pallas kernel in interpret
mode (``MXTPU_FLASH_ATTENTION=1``), gradients kept readable after its fused
step (``MXTPU_FUSED_GRADS=1``), and no parameter donation.
``PYTHONPATH=. python tests/test_torch_module.py`` prints the gaps that the
limits below were set from."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

VOCAB, LAYERS, HIDDEN, HEADS, SEQ, BATCH = 64, 2, 32, 4, 32, 2
LR, STEPS = 1e-3, 3
# Limits, measured on the CPU (seeds 0/1 of the weights and batches):
# - fp32: outputs 9.5e-7, each gradient array within 8.0e-7 of its own
#   max-abs, weights after 3 steps 2.8e-6. Adam turns a gradient's sign
#   into a step of about lr whatever its size, so an entry whose gradient
#   sits at fp32 noise could move 2 lr apart; none does here, and weights
#   are held to lr / 10.
# - bf16: both packages compute in bf16, but XLA on the CPU keeps some
#   elementwise ops in fp32 that the port rounds, so the port's bf16
#   gradients sit 1.25-1.8x as far from the fp32 ones as the reference's
#   (per-array gap to fp32: max 0.14 vs 0.11). Gradients are held per array
#   to 0.3 of their max-abs (read 0.14) with a median over arrays of 0.1
#   (read 0.04); weights to 2 lr per step (read 4.4e-3 of 6e-3) with a mean
#   of lr / 4 (read 6.7e-5); the dense head's probabilities to 1e-2 (read
#   3.1e-3) and the fused head's per-token NLL to 0.1 (read 2.8e-2).
#   Each Adam step moves a weight by about lr, so 2 lr per step is about the
#   widest gap two runs can have: it passes a skipped update and fails a
#   negated one by 0.1 %. ``w_mean`` is the limit that tells a right update
#   from a wrong one (test_bf16_weight_mean_catches_a_wrong_update).
LIMITS = {
    None: dict(out=1e-5, grad=1e-5, grad_median=1e-5, w=LR / 10,
               w_mean=LR / 10),
    "bfloat16": dict(out=None, grad=0.3, grad_median=0.1, w=2 * LR * STEPS,
                     w_mean=LR / 4),
}
BF16_OUT = {False: 1e-2, True: 0.1}


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")
    monkeypatch.setenv("MXTPU_FLASH_ATTENTION", "1")
    monkeypatch.setenv("MXTPU_FUSED_GRADS", "1")
    monkeypatch.delenv("MXTPU_DONATE_PARAMS", raising=False)


def _lm(pkg, fused):
    return pkg.models.transformer_lm.get_symbol(
        vocab_size=VOCAB, num_layers=LAYERS, hidden=HIDDEN, heads=HEADS,
        seq_len=SEQ, fused_head=fused)


def _weights(symbol, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    out = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        scale = 1.0 / np.sqrt(shape[-1]) if len(shape) == 2 else 0.1
        out[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
        if name.endswith("_gamma"):
            out[name] += 1.0
    return out


def _batches(n, seed=1):
    """Random int32 tokens; labels are the next token, -1 at the end."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
        y = np.roll(x, -1, axis=1).astype(np.float32)
        y[:, -1] = -1
        out.append((x, y))
    return out


def _module(pkg, fused, amp, weights):
    mod = pkg.mod.Module(_lm(pkg, fused), context=pkg.cpu(), amp=amp)
    mod.bind(data_shapes=[("data", (BATCH, SEQ))],
             label_shapes=[("softmax_label", (BATCH, SEQ))])
    mod.init_params(arg_params={n: pkg.nd.array(w, pkg.cpu())
                                for n, w in weights.items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": LR})
    return mod


def _train(pkg, fused, amp, weights, batches):
    """First-step outputs and gradients, and the weights after the steps."""
    mod = _module(pkg, fused, amp, weights)
    first = None
    for x, y in batches:
        mod.forward(pkg.io.DataBatch(
            data=[pkg.nd.array(x, pkg.cpu(), dtype=np.int32)],
            label=[pkg.nd.array(y, pkg.cpu())]), is_train=True)
        mod.backward()
        if first is None:
            grads = mod._exec_group._executor.grad_dict
            first = (mod.get_outputs()[0].asnumpy(),
                     {n: grads[n].asnumpy() for n in weights})
        mod.update()
    arg_params, _ = mod.get_params()
    return first, {n: arg_params[n].asnumpy() for n in weights}


def _gaps(fused, amp):
    weights = _weights(_lm(mxt, fused))
    batches = _batches(STEPS)
    (t_out, t_grad), t_w = _train(mxt, fused, amp, weights, batches)
    (j_out, j_grad), j_w = _train(mxj, fused, amp, weights, batches)
    rel = {n: np.abs(t_grad[n] - j_grad[n]).max()
           / max(np.abs(j_grad[n]).max(), 1e-30) for n in weights}
    dw = np.concatenate([np.abs(t_w[n] - j_w[n]).ravel() for n in weights])
    return {"out": float(np.abs(t_out - j_out).max()),
            "grad": float(max(rel.values())),
            "grad_median": float(np.median(list(rel.values()))),
            "w": float(dw.max()), "w_mean": float(dw.mean()),
            "finite": bool(np.isfinite(t_out).all()
                           and all(np.isfinite(g).all()
                                   for g in t_grad.values()))}


@pytest.mark.parametrize("amp", [None, "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
def test_module_matches_reference_module(fused, amp):
    """Three Adam steps through forward(is_train=True)/backward()/update()
    in both packages: first-step outputs and gradients, then weights."""
    gaps = _gaps(fused, amp)
    lim = LIMITS[amp]
    assert gaps["finite"]
    assert gaps["out"] <= (lim["out"] or BF16_OUT[fused]), gaps
    for key in ("grad", "grad_median", "w", "w_mean"):
        assert gaps[key] <= lim[key], (key, gaps)


@pytest.mark.parametrize("fault", ["skip", "negate"])
def test_bf16_weight_mean_catches_a_wrong_update(monkeypatch, fault):
    """A planted fault in the port's Adam update (no update, or the
    gradient's sign turned) fails the bf16 ``w_mean`` limit. Read on the
    CPU: w_mean 1.7e-3 (skip) and 3.5e-3 (negate) against 2.5e-4, while the
    ``w`` limit passes the skipped update (3.0e-3 of 6e-3)."""
    update = mxt.optimizer.Adam.update
    tree_update = mxt.optimizer.Adam._tree_update

    def wrong(self, index, weight, grad, state):
        if fault == "negate":
            update(self, index, weight, grad * -1.0, state)

    def wrong_tree(self, w, g, s, lr, wd):
        # the fused step's rule, which the module runs unless
        # MXTPU_NO_FUSED_STEP=1
        if fault == "negate":
            tree_update(self, w, g * -1.0, s, lr, wd)

    monkeypatch.setattr(mxt.optimizer.Adam, "update", wrong)
    monkeypatch.setattr(mxt.optimizer.Adam, "_tree_update", wrong_tree)
    gaps = _gaps(False, "bfloat16")
    assert gaps["w_mean"] > 2 * LIMITS["bfloat16"]["w_mean"], gaps


def test_module_trains_on_repeated_batch():
    """The loss falls on a repeated batch (the chip phase's gate)."""
    weights = _weights(_lm(mxt, True))
    (x, y), = _batches(1)
    mod = _module(mxt, True, "bfloat16", weights)
    batch = mxt.io.DataBatch(data=[mxt.nd.array(x, mxt.cpu(), dtype="int32")],
                             label=[mxt.nd.array(y, mxt.cpu())])
    losses = []
    for _ in range(5):
        mod.forward_backward(batch)
        nll = mod.get_outputs()[0].asnumpy()
        losses.append(nll[y.reshape(-1) != -1].mean())
        mod.update()
    assert losses[-1] < losses[0] - 0.1, losses


def test_module_params_round_trip_and_fixed_params():
    """get_params/set_params round-trip; a fixed parameter gets no gradient
    and stays as it was; the weights the optimizer updates are the ones the
    next forward reads."""
    weights = _weights(_lm(mxt, False))
    mod = mxt.mod.Module(_lm(mxt, False), context=mxt.cpu(),
                         fixed_param_names=["tok_embed_weight"])
    mod.bind(data_shapes=[("data", (BATCH, SEQ))],
             label_shapes=[("softmax_label", (BATCH, SEQ))])
    mod.set_params({n: mxt.nd.array(w, mxt.cpu())
                    for n, w in weights.items()}, {})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    ex = mod._exec_group._executor
    assert ex.grad_req["tok_embed_weight"] == "null"
    assert ex.grad_req["data"] == ex.grad_req["softmax_label"] == "null"
    assert set(ex.grad_dict) == set(weights) - {"tok_embed_weight"}
    (x, y), = _batches(1)
    batch = mxt.io.DataBatch(data=[mxt.nd.array(x, mxt.cpu())],
                             label=[mxt.nd.array(y, mxt.cpu())])
    mod.forward_backward(batch)
    mod.update()
    head = ex.arg_dict["head_weight"]
    arg_params, _ = mod.get_params()
    np.testing.assert_array_equal(arg_params["tok_embed_weight"].asnumpy(),
                                  weights["tok_embed_weight"])
    np.testing.assert_array_equal(arg_params["head_weight"].asnumpy(),
                                  head.asnumpy())
    assert np.abs(head.asnumpy() - weights["head_weight"]).max() > 1e-4
    mod.forward(batch, is_train=False)
    p_after = mod.get_outputs()[0].asnumpy()
    mod.set_params({n: mxt.nd.array(w, mxt.cpu())
                    for n, w in weights.items()}, {})
    mod.forward(batch, is_train=False)
    assert np.abs(mod.get_outputs()[0].asnumpy() - p_after).max() > 1e-6


def test_module_input_grads_match_reference():
    """inputs_need_grad: the gradient of an fp32 ``data`` input, through a
    small MLP with a SoftmaxOutput head, as the reference gives it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    w = {"fc_weight": rng.standard_normal((3, 6)).astype(np.float32),
         "fc_bias": np.zeros(3, np.float32)}
    got = {}
    for pkg in (mxt, mxj):
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={n: pkg.nd.array(a, pkg.cpu())
                                    for n, a in w.items()})
        mod.forward_backward(pkg.io.DataBatch(
            data=[pkg.nd.array(x, pkg.cpu())],
            label=[pkg.nd.array(y, pkg.cpu())]))
        got[pkg] = mod.get_input_grads()[0].asnumpy()
    np.testing.assert_allclose(got[mxt], got[mxj], rtol=1e-5, atol=1e-6)


def test_module_defaults_to_the_card(monkeypatch):
    """With no context the Module binds on gpu(0); without a card that
    raises instead of falling back to the CPU."""
    mod = mxt.mod.Module(_lm(mxt, True))
    assert mod._context == [mxt.gpu(0)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mod.bind(data_shapes=[("data", (BATCH, SEQ))],
                 label_shapes=[("softmax_label", (BATCH, SEQ))])


def test_local_kvstore_on_one_device_is_none():
    """``kvstore="local"`` (or "device") on one device means no kvstore, as
    in the reference (``model._create_kvstore``); a ``dist*`` string makes
    a store that runs the update, and so does a store given as an object."""
    create = mxt.model._create_kvstore
    assert create("local", 1, {}) == (None, False)
    assert create("device", 1, {}) == (None, False)
    assert create(None, 1, {}) == (None, False)
    kv, on_kv = create("dist_sync", 1, {})
    assert isinstance(kv, mxt.kv.KVStore) and kv.type == "dist_sync" and on_kv
    local = mxt.kv.create("local")
    assert create(local, 1, {}) == (local, True)
    with pytest.raises(TypeError):
        create(1, 1, {})


def test_train_lm_example_on_cpu():
    """The training example runs on the CPU when asked and its perplexity
    falls within a few steps (the 800-step gate runs on the card)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one thread: beside the other test workers, a process that spreads
    # torch's thread pool over every core slows all of them down
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.train_lm", "--cpu",
         "--steps", "100", "--batch", "8"], cwd=root, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    ppl = [float(line.split("perplexity ")[1].split()[0])
           for line in out.stdout.splitlines() if "perplexity" in line]
    assert len(ppl) == 3 and ppl[-1] < ppl[0], out.stdout


if __name__ == "__main__":
    os.environ.update(MXNET_GRAPHOPT="0", MXTPU_FLASH_ATTENTION="1",
                      MXTPU_FUSED_GRADS="1")
    os.environ.pop("MXTPU_DONATE_PARAMS", None)
    for _fused in (False, True):
        for _amp in (None, "bfloat16"):
            print(f"fused={_fused} amp={_amp}:", _gaps(_fused, _amp))
