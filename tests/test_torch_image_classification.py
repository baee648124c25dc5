"""The port's image-classification entry points on the CPU:
``train_mnist.py`` (LeNet and the MLP) reaching the LeNet flow's gate, a
checkpoint written by the JAX package's ``score.py`` flow scored by the
port's ``score.py`` to the JAX accuracy and cross-entropy (1e-5),
``fine_tune.py``'s frozen body (drift 0) and gate, and ``benchmark.py`` and
``benchmark_score.py`` at tiny sizes printing the reference's formats;
``benchmark.py`` sweeps data-parallel degrees (its ``--tp`` raises)."""
import importlib.util
import os
import re
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.examples.image_classification import (
    benchmark, benchmark_score, fine_tune, score, train_mnist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = 0.95          # the LeNet flow's validation accuracy


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads while this file runs (the tier-1 run puts six
    test workers on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXTPU_NO_FUSED_STEP", "MXTPU_FUSED_GRADS",
              "MXTPU_DONATE_PARAMS", "MXNET_RUN_N_STEPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_GRAPHOPT", "0")


@pytest.mark.parametrize("network", ["lenet", "mlp"])
def test_train_mnist_reaches_the_gate(network, tmp_path):
    """Two epochs (the defaults' ten take about 20 s here) on the
    synthetic digits (no idx files under ``--data-dir``)."""
    mod, acc = train_mnist.main(
        ["--cpu", "--network", network, "--num-epochs", "2",
         "--data-dir", str(tmp_path / "none")])
    assert acc >= GATE
    assert mod.get_outputs()[0].shape == (64, 10)


def test_synthetic_digits_are_the_reference_scripts():
    spec = importlib.util.spec_from_file_location(
        "ref_train_mnist", os.path.join(
            ROOT, "example", "image-classification", "train_mnist.py"))
    src = open(spec.origin).read()
    # the reference builds them inline: the same RandomState(0) stream
    assert "proto = rng.rand(10, 28, 28)" in src
    tl, ti, vl, vi = train_mnist.synthetic_digits()
    rng = np.random.RandomState(0)
    proto = rng.rand(10, 28, 28).astype(np.float32)
    lbl = rng.randint(0, 10, 6000)
    assert np.array_equal(tl, lbl)
    np.testing.assert_array_equal(
        ti, (proto[lbl] * 255 + rng.randn(6000, 28, 28) * 16).clip(0, 255))
    assert ti.shape == (6000, 28, 28) and vi.shape == (1000, 28, 28)
    assert vl.shape == (1000,)


def _reference_score_main(prefix, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "ref_score", os.path.join(ROOT, "example", "image-classification",
                                  "score.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["score.py", "--prefix", prefix])
    return {m.get()[0]: m.get()[1] for m in mod.main()}


def test_score_of_a_reference_checkpoint(tmp_path, monkeypatch, capsys):
    """The JAX package's score.py trains LeNet, checkpoints it and scores
    it; the port's score.py scores the same files."""
    prefix = str(tmp_path / "score_demo")
    want = _reference_score_main(prefix, monkeypatch)
    assert os.path.exists(prefix + "-0002.params")
    got = {m.get()[0]: m.get()[1] for m in score.main(
        ["--prefix", prefix, "--cpu"])}
    assert set(got) == {"accuracy", "cross-entropy"} == set(want)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), k
    assert got["accuracy"] >= GATE
    out = capsys.readouterr().out
    assert re.search(r"^accuracy: \d\.\d{4}$", out, re.M)
    assert re.search(r"^cross-entropy: \d+\.\d{4}$", out, re.M)


def test_score_trains_its_own_checkpoint(tmp_path):
    got = {m.get()[0]: m.get()[1] for m in score.main(
        ["--prefix", str(tmp_path / "own"), "--cpu"])}
    assert got["accuracy"] >= GATE
    assert os.path.exists(str(tmp_path / "own-symbol.json"))


def test_fine_tune_keeps_the_body_frozen(tmp_path):
    acc, drift = fine_tune.main(["--prefix", str(tmp_path / "ft"), "--cpu"])
    assert drift == 0.0
    assert acc >= 0.9


def test_fine_tune_model_slices_at_flatten():
    with mxt.name.NameManager():
        net = mxt.models.lenet.get_symbol(10)
    new = fine_tune.get_fine_tune_model(net, 4)
    args = new.list_arguments()
    assert args[-3:] == ["fc_new_weight", "fc_new_bias", "softmax_label"]
    assert "fullyconnected0_weight" not in args
    assert new.infer_shape(data=(2, 1, 28, 28))[1] == [(2, 4)]


def test_benchmark_prints_the_reference_csv(capsys):
    rows = benchmark.main(["--cpu", "--networks", "lenet,mlp",
                           "--batch-sizes", "2,4", "--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "network,devices,tp,batch,img_per_sec,speedup_vs_1dev"
    assert len(lines) == 5 and len(rows) == 4
    for line, net, bs in zip(lines[1:], ("lenet", "lenet", "mlp", "mlp"),
                             (2, 4, 2, 4)):
        assert re.fullmatch(rf"{net},1,1,{bs},\d+\.\d,1\.00", line), line


@pytest.mark.parametrize("argv", [["--devices", "1,2", "--tp", "2"],
                                  ["--tp", "2"],
                                  ["--devices", "4", "--tp", "2"]])
def test_benchmark_over_several_devices_is_not_ported(argv):
    """Model parallelism (``--tp`` above 1) is not ported; data parallelism
    over several devices is (the test below)."""
    with pytest.raises(mxt.MXNetError, match="not ported"):
        benchmark.main(["--cpu", "--networks", "lenet"] + argv)


def test_benchmark_sweeps_data_parallel_degrees(capsys):
    """``--devices 1,2`` times each batch over one context and over two
    (``cpu(0)``, ``cpu(1)``), the speedup over one device beside it; a
    batch that two contexts do not divide is skipped."""
    rows = benchmark.main(["--cpu", "--networks", "lenet", "--devices",
                           "1,2", "--batch-sizes", "3,4", "--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [r[:4] for r in rows] == [("lenet", 1, 1, 3), ("lenet", 1, 1, 4),
                                     ("lenet", 2, 1, 4)]
    assert len(lines) == 4 and rows[2][5] == rows[2][4] / rows[1][4]
    assert re.fullmatch(r"lenet,2,1,4,\d+\.\d,\d+\.\d\d", lines[3]), lines


class _ForwardClock:
    """A clock for ``benchmark_score``'s timing that advances 1 ms a
    ``Module.forward`` and not otherwise, so the rate is exact whatever
    the host's load (a difference of two short timed runs on a real clock
    can come out negative)."""

    now = 0.0

    @classmethod
    def time(cls):
        return cls.now


def test_benchmark_score_prints_the_reference_line(capsys, monkeypatch):
    forward = mxt.mod.Module.forward

    def ticking(self, *a, **k):
        _ForwardClock.now += 1e-3
        return forward(self, *a, **k)

    monkeypatch.setattr(benchmark_score, "time", _ForwardClock)
    monkeypatch.setattr(mxt.mod.Module, "forward", ticking)
    rates = benchmark_score.main(
        ["--cpu", "--networks", "lenet,mlp", "--batch-sizes", "1,2",
         "--num-batches", "4", "--image-shape", "1,28,28"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and len(rates) == 4
    for line in lines:
        assert re.fullmatch(r"network: (lenet|mlp) batch: [12]  \d+\.\d "
                            r"img/s", line), line
    # batch x (4 - 2) forwards over their 2 ms
    assert rates == pytest.approx({(n, b): 1000.0 * b for n in
                                   ("lenet", "mlp") for b in (1, 2)})


def test_images_per_s_is_the_difference_of_two_runs():
    """The reference's rate: batch x (n - n // 4) over the difference of a
    run of n forwards and one of n // 4 (each after three forwards)."""
    calls = []

    def forward():
        calls.append("f")
        time.sleep(1e-3)

    rate = benchmark_score.images_per_s(forward, lambda: calls.append("r"),
                                        8, 20)
    assert calls == ["f"] * 3 + ["r"] + ["f"] * 5 + ["r"] + ["f"] * 20 \
        + ["r"]
    assert rate > 0
