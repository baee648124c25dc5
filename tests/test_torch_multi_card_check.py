"""``mxnet_tpu_torch/tools/multi_card_check.py`` on the CPU: two gloo
workers through ``tools/launch.py`` pass the kvstore asserts, two LeNet
workers equal one process over two ``cpu(i)`` contexts bit for bit, and
the BatchNorm net and ResNet-8 in fp32 over two contexts stay within fp32
noise of one context (limits 1e-6 of the largest entry and 1e-5 of each
array's max-abs; read 1.2e-7 and 5.4e-7). The same script, without
``--cpu``, runs the version on a host with 4 cards."""
import os

import pytest

from mxnet_tpu_torch.tools import multi_card_check


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("MXTPU_NO_FUSED_STEP", raising=False)


def test_multi_card_check_on_cpu_contexts():
    out = multi_card_check.main(["--cpu", "--cards", "2", "--steps", "2"])
    assert out["device"] == {"platform": "cpu", "count": 2}
    assert out["workers"] == {"rc": 0, "ok": 2, "backends": ["gloo"]}
    assert out["lenet"]["rc"] == [0, 0] and out["lenet"]["workers_equal"]
    assert out["lenet"]["vs_one_process_max_abs"] <= 1e-6
    assert out["bn_net"]["max_abs"] <= 1e-6
    assert out["bn_net"]["outputs_max_abs"] <= 1e-6
    fp32 = out["resnet8_float32_b16"]
    for steps in ("steps_1", "steps_2"):
        assert fp32[steps]["n_vs_1"][0][0] <= 1e-5, fp32[steps]
        assert fp32[steps]["1_vs_1"][0][0] == 0.0
        assert fp32[steps]["moved_1e-7_vs_1"][0][0] > 0.0
    assert "resnet8_bfloat16_b16" in out
    assert "MXTPU_NO_FUSED_STEP" not in os.environ


def test_multi_card_trace_on_cpu_contexts():
    """``--trace`` over two ``cpu(i)`` contexts: the step's host parts
    and the profiler's breakdown for one context and for two."""
    out = multi_card_check.main(["--cpu", "--cards", "2", "--trace"])
    assert set(out) == {"device", "contexts", "resnet8_float32_b16",
                        "resnet8_bfloat16_b16"}
    assert "MXTPU_NO_FUSED_STEP" not in os.environ
    for cell in ("resnet8_float32_b16", "resnet8_bfloat16_b16"):
        for k in ("cards_1", "cards_2"):
            got = out[cell][k]
            assert set(got["host_ms"]) == {"forward", "backward", "update",
                                           "wait", "step", "walk",
                                           "autograd"}
            assert got["host_ms"]["step"] > 0
            assert 0 < got["host_ms"]["walk"] < got["host_ms"]["forward"]
            assert got["busy_ms"] == {} and got["kernels"] == {}
