"""Flash attention forward as a hand-written CUDA kernel for Hopper.

Port of mxnet_tpu/ops/flash_attention.py, whose forward is a Pallas TPU kernel
(``_fwd_kernel``). Here the kernel is ``csrc/flash_attention_fwd.cu``: it
streams K/V tiles through shared memory with an online softmax, so the
(T, T) score matrix never reaches device memory. It is built with ``nvcc``
at first use and called through ``ctypes``.

Layout is (B, T, H, D), as in the reference. :func:`flash_attention` routes
by the device of its inputs: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version :func:`flash_attention_reference`, and a
``meta`` tensor returns an empty result of the right shape for shape
inference. Only CUDA launches count in ``flash_attention.launches``. The
backward waits for the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

__all__ = ["copy_bytes", "flash_attention", "flash_attention_reference",
           "use_flash"]

_KERNEL = "flash_attention_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def use_flash(t_len: int, block: int = 128, on_accel: bool = False) -> bool:
    """Whether attention over ``t_len`` positions launches the flash kernel.

    The reference gates its Pallas kernel on ``t_len >= block``, a multiple
    of the block, and ``MXTPU_FLASH_ATTENTION``, because that kernel needs
    block-divisible T. The CUDA kernel masks a ragged T itself, so here the
    answer is the inputs' device alone: always on the card (``on_accel``,
    the inputs' ``is_cuda``), never off it, where :func:`flash_attention`
    takes the plain version. ``t_len`` and ``block`` are kept for the
    reference's signature."""
    return bool(on_accel)


def flash_attention_reference(q, k, v, causal=False, scale=None, block_q=128,
                              block_k=128, q_offset=0):
    """Plain PyTorch attention with the kernel's semantics, from
    ``local_attention``'s math: fp32 scores and softmax, output in q's
    dtype. The block sizes do not change the result."""
    from ..parallel.ring_attention import local_attention

    o, m, l = local_attention(q.float(), k.float(), v.float(), causal=causal,
                              q_offset=q_offset, scale=scale)
    out = o / l.clamp(min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def copy_bytes(d: int, *ptrs: int) -> int:
    """Width in bytes of the fp32 kernel's ``cp.async`` copies for head dim
    ``d`` and the tensors' base addresses ``ptrs``: 16 when every row of
    ``d`` floats starts 16-byte aligned (``d % 4 == 0`` and each base
    pointer a multiple of 16), else 4. The kernel is instantiated for both;
    a contiguous view at a 4-byte offset (``buf[1:].view(...)``) takes 4."""
    return 16 if d % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 4


def _check(q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k, v must be (B, T, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise MXNetError("flash_attention: shapes do not match: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise MXNetError("flash_attention: q, k, v of different dtypes")
    if int(q_offset) < 0:
        raise MXNetError(f"flash_attention: q_offset {q_offset} < 0")


def _check_cuda(q, k, v):
    if q.dtype not in _DTYPE_CODES:
        raise MXNetError(f"flash_attention: the CUDA kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head dim {q.shape[-1]} > "
                         f"{_MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention: the CUDA kernel needs contiguous "
                         "q, k, v")
    if q.shape[0] * q.shape[2] > 65535:
        raise MXNetError("flash_attention: batch * heads > 65535")


def entry(lib):
    """``mxtt_flash_attention_fwd`` of a loaded kernel library, typed for
    ``ctypes``: (q, k, v, o, batch, t_q, t_k, heads, d, scale, causal,
    q_offset, dtype, copy_bytes, stream) -> cudaError_t."""
    fn = lib.mxtt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, scale, q_offset):
    from .. import _native

    fn = entry(_native.load(_KERNEL))
    b, t_q, h, d = q.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b, t_q, k.shape[1], h, d, float(scale),
                 int(bool(causal)), int(q_offset), _DTYPE_CODES[q.dtype],
                 copy_bytes(d, *ptrs), stream)
    if err != 0:
        raise MXNetError(f"flash_attention: CUDA kernel launch failed "
                         f"(cudaError_t {err})")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128, q_offset=0):
    """Attention over (B, T, H, D) without materializing (T, T) scores.

    Same signature as the reference minus ``interpret``. ``block_q`` and
    ``block_k`` are the reference's tiling; the CUDA kernel uses its own
    tiles and the result does not depend on them."""
    _check(q, k, v, q_offset)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, block_q,
                                         block_k, q_offset)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v)
    if q.numel() == 0 or k.shape[1] == 0:
        raise MXNetError("flash_attention: empty q or k")
    return _launch(q, k, v, causal, scale, q_offset)


flash_attention.launches = 0
