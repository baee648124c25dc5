"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. This file imports no JAX, so it runs on a machine with only PyTorch
(``--noconftest`` skips the JAX set-up in tests/conftest.py):

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_kernels.py

Without a CUDA device each test skips."""
import pytest
import torch

from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tfa


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,q_offset,t_q,t_k,d", [
    (True, 0, 256, 256, 64), (True, 64, 200, 264, 64),
    (False, 0, 100, 70, 32), (True, 0, 128, 128, 128)])
def test_cuda_kernel_matches_plain(dtype, tol, causal, q_offset, t_q, t_k, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, t_q, 3, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, t_k, 3, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, t_k, 3, d), generator=g, device="cuda").to(dtype)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal, q_offset=q_offset)
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("flag", [None, "0"])
@pytest.mark.parametrize("t", [64, 200, 2048])
def test_full_attention_launches_kernel_at_any_t(monkeypatch, flag, t):
    """On the card the attention op launches the kernel at every T, ragged
    and short ones too, and MXTPU_FLASH_ATTENTION=0 does not turn it off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    if flag is None:
        monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_ATTENTION", flag)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((1, t, 2, 64), generator=g, device="cuda")
               for _ in range(3))
    before = tfa.flash_attention.launches
    got = tattn._full_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v, causal=True)
    assert float((got - want).abs().max()) <= 1e-4
