"""The port's slice end to end: transformer-LM inference through Predictor,
against the JAX package's Predictor on identical numpy weights and tokens,
with MXTPU_FLASH_ATTENTION=1 on both sides (the JAX side runs the Pallas
kernel in interpret mode, the port its plain version on the CPU). Also the
two packages' symbol JSON and .params formats, read across."""
import os
import tempfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops import flash_attention as tfa

VOCAB, LAYERS, HIDDEN, HEADS, SEQ, BATCH = 64, 2, 32, 4, 32, 2
SHAPES = {"data": (BATCH, SEQ), "softmax_label": (BATCH, SEQ)}


def _symbols(hidden=HIDDEN, heads=HEADS):
    kw = dict(vocab_size=VOCAB, num_layers=LAYERS, hidden=hidden,
              heads=heads, seq_len=SEQ)
    return (mxj.models.transformer_lm.get_symbol(**kw),
            mxt.models.transformer_lm.get_symbol(**kw))


def _weights(symbol, seed=0):
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = symbol.infer_shape(**SHAPES)
    out = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in SHAPES:
            continue
        scale = 1.0 / np.sqrt(shape[-1]) if len(shape) == 2 else 0.1
        out[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
        if name.endswith("_gamma"):
            out[name] += 1.0
    return out


@pytest.fixture
def flash_on(monkeypatch):
    monkeypatch.setenv("MXTPU_FLASH_ATTENTION", "1")


def test_lm_probs_match_jax_predictor(flash_on, monkeypatch):
    _lm_probs_match_jax_predictor(monkeypatch, HIDDEN, HEADS)


def test_lm_probs_match_jax_predictor_at_head_dim_256(flash_on,
                                                      monkeypatch):
    """2 heads of 256 (hidden 512): on the card fp32 attention at this head
    dim runs flash_fwd_f32_wide; here the same wrapper takes its plain
    version."""
    _lm_probs_match_jax_predictor(monkeypatch, 512, 2)


def test_lm_probs_match_jax_predictor_at_head_dim_512(flash_on,
                                                      monkeypatch):
    """2 heads of 512 (hidden 1024): on the card fp32 attention at this head
    dim runs flash_fwd_f32_cluster (a cluster of four blocks, each a
    128-wide chunk of d); here the same wrapper takes its plain version."""
    _lm_probs_match_jax_predictor(monkeypatch, 1024, 2)


def _lm_probs_match_jax_predictor(monkeypatch, hidden, heads):
    sj, st = _symbols(hidden, heads)
    params = _weights(st)
    tokens = np.random.default_rng(1).integers(
        0, VOCAB, (BATCH, SEQ)).astype(np.float32)

    pj = mxj.Predictor.from_arrays(sj, params, {}, SHAPES)
    pj.forward(data=tokens)
    want = pj.get_output(0)

    calls = []
    plain = tfa.flash_attention_reference
    monkeypatch.setattr(tfa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    arg, aux = mxt.convert.params_from_numpy(params, {}, mxt.cpu())
    pt = mxt.Predictor.from_arrays(st, arg, aux, SHAPES, ctx=mxt.cpu())
    assert pt.output_shapes == [(BATCH * SEQ, VOCAB)]
    calls.clear()   # shape inference runs on meta tensors, not the plain path
    pt.forward(data=tokens)
    got = pt.get_output(0)

    assert len(calls) == LAYERS   # every layer took the flash wrapper
    assert got.shape == want.shape == (BATCH * SEQ, VOCAB)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_predictor_from_jax_json_and_params_bytes(flash_on, tmp_path):
    """MXPredCreate's form: symbol JSON and a .params blob written by the
    JAX package."""
    sj, st = _symbols()
    params = _weights(st, seed=3)
    path = str(tmp_path / "lm.params")
    mxj.nd.save(path, {f"arg:{k}": mxj.nd.array(v)
                       for k, v in params.items()})
    with open(path, "rb") as f:
        blob = f.read()
    tokens = np.random.default_rng(4).integers(
        0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    pj = mxj.Predictor(sj.tojson(), blob, SHAPES)
    pj.forward(data=tokens)
    pt = mxt.Predictor(sj.tojson(), blob, SHAPES, ctx=mxt.cpu())
    pt.forward(data=tokens)
    np.testing.assert_allclose(pt.get_output(0), pj.get_output(0), atol=1e-5)


def test_label_shape_must_be_given():
    """The label's shape is not inferable back through Reshape(label,
    shape=(-1,)), so an LM predictor needs softmax_label in input_shapes."""
    _, st = _symbols()
    arg, _ = mxt.convert.params_from_numpy(_weights(st), {}, mxt.cpu())
    with pytest.raises(mxt.MXNetError, match="missing parameter softmax_label"):
        mxt.Predictor.from_arrays(st, arg, {}, {"data": (BATCH, SEQ)},
                                  ctx=mxt.cpu())


def test_symbol_json_loads_across_packages():
    sj, st = _symbols()
    for src, loader in ((sj, mxt.sym.load_json), (st, mxj.sym.load_json)):
        back = loader(src.tojson())
        assert back.list_arguments() == src.list_arguments()
        assert back.list_outputs() == src.list_outputs()
        assert back.infer_shape(**SHAPES) == src.infer_shape(**SHAPES)
    assert st.list_arguments() == sj.list_arguments()
    assert st.infer_shape(**SHAPES) == sj.infer_shape(**SHAPES)


def test_params_bytes_equal_across_packages():
    import ml_dtypes

    rng = np.random.default_rng(5)
    arrays = {
        "arg:w": rng.standard_normal((3, 4)).astype(np.float32),
        "arg:ids": rng.integers(-5, 5, (7,)).astype(np.int32),
        "aux:h": rng.standard_normal((2, 2)).astype(np.float16),
        "arg:b": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
    }
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.params")
        mxj.nd.save(path, {k: mxj.nd.array(v, dtype=v.dtype)
                           for k, v in arrays.items()})
        with open(path, "rb") as f:
            blob = f.read()
        loaded = mxt.nd.load_frombuffer(blob, mxt.cpu())
        assert set(loaded) == set(arrays)
        for k, v in arrays.items():
            t = loaded[k].data
            raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
            assert tuple(t.shape) == v.shape
            assert raw.numpy().tobytes() == v.tobytes(), k
        # and back: the port's save is the same container
        back = os.path.join(d, "y.params")
        mxt.nd.save(back, loaded)
        with open(back, "rb") as f:
            assert f.read() == blob
        arg, aux = mxt.convert.params_from_bytes(blob, mxt.cpu())
        assert set(arg) == {"w", "ids", "b"} and set(aux) == {"h"}


def test_entry_points_default_to_the_card(tmp_path):
    """The default context is gpu(0); without a card, an entry point that
    is not given mx.cpu() raises instead of running on the host."""
    assert mxt.current_context() == mxt.gpu(0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mxt.MXNetError, match="needs a CUDA device"):
        mxt.nd.zeros((2, 2))
    _, st = _symbols()
    with pytest.raises(mxt.MXNetError, match="needs a CUDA device"):
        mxt.Predictor.from_arrays(st, _weights(st), {}, SHAPES)
    assert mxt.nd.zeros((2, 2), mxt.cpu()).context == mxt.cpu()
    # loading a .params blob places it like every other entry point
    blob_path = str(tmp_path / "w.params")
    mxt.nd.save(blob_path, {"arg:w": mxt.nd.zeros((2, 2), mxt.cpu())})
    with open(blob_path, "rb") as f:
        blob = f.read()
    for load in (lambda: mxt.nd.load_frombuffer(blob),
                 lambda: mxt.nd.load(blob_path),
                 lambda: mxt.convert.params_from_bytes(blob)):
        with pytest.raises(mxt.MXNetError, match="needs a CUDA device"):
            load()
    assert mxt.nd.load_frombuffer(blob, mxt.cpu())["arg:w"].context \
        == mxt.cpu()


def test_import_pulls_in_no_jax_and_no_cuda():
    """The port stands alone: importing it (and building the LM symbol)
    loads neither JAX nor the JAX package, and does not initialise CUDA."""
    import subprocess
    import sys

    code = ("import sys, torch, mxnet_tpu_torch as mx; "
            "mx.models.transformer_lm.get_symbol().infer_shape("
            "data=(2, 32), softmax_label=(2, 32)); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']; "
            "assert not bad, bad; "
            "assert not torch.cuda.is_initialized()")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
