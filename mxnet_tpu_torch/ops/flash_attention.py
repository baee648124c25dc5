"""Flash attention forward as a hand-written CUDA kernel for Hopper.

Port of mxnet_tpu/ops/flash_attention.py, whose forward is a Pallas TPU kernel
(``_fwd_kernel``). Here there are two kernels, one for each kind of input:
fp32 runs on CUDA cores (``csrc/flash_attention_fwd.cu``), bf16 and fp16 on
the tensor cores (``csrc/flash_attention_fwd_tc.cu``). Both stream K/V tiles
through shared memory with an online softmax, so the (T, T) score matrix
never reaches device memory. Any head dim runs (:func:`launch_plan`):
bf16/fp16 up to 256 on ``wgmma``, fed by TMA where the rows are 16-byte
aligned (``flash_fwd_tc_wg``) and by a producer without TMA where they are
not (``flash_fwd_tc_wg_ldg``), and above 256 in thread-block clusters of
such blocks, each over a 192-wide chunk of d (``flash_fwd_tc_cluster``,
``flash_fwd_tc_cluster_ldg``; past 8 chunks in groups of clusters, each
group computing the scores once); fp32 up to 128 in ``flash_fwd_f32``,
from 129 to
256 in a kernel whose block owns all of d, and above 256 in clusters whose
blocks each own a 128-wide chunk of d (``flash_fwd_f32_cluster``; past 16
chunks in groups of clusters, each group computing the scores once). The
blocks of a cluster sum their partial scores through distributed shared
memory. Each is built with ``nvcc`` at first use and called through
``ctypes``.

Layout is (B, T, H, D), as in the reference. :func:`flash_attention` routes
by the device of its inputs: a CUDA tensor launches the kernel (or raises),
a CPU tensor takes the plain version :func:`flash_attention_reference`, and a
``meta`` tensor returns an empty result of the right shape for shape
inference. Only CUDA launches count: in ``flash_attention.launches``, and
by input dtype in ``flash_attention.launches_by_dtype`` and by kernel (the
names of :func:`launch_plan`) in ``flash_attention.launches_by_kernel``,
which tell which kernel a path ran.

The gradient is the reference's ``custom_vjp`` (``bwd`` of its
``flash_attention``) as a ``torch.autograd.Function``: the forward is the
routed forward above, only q, k and v are saved, and the backward recomputes
attention in fp32 through ``local_attention`` and differentiates that
recompute. The backward launches no kernel and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..ndarray import _dtype_name

__all__ = ["cluster_groups", "copy_bytes", "flash_attention",
           "flash_attention_reference", "launch_plan", "reset_launches",
           "tc_cluster_groups", "use_flash"]

# dtype -> (library, C entry, the entry's dtype code)
_KERNELS = {
    torch.float32: ("flash_attention_fwd", "mxtt_flash_attention_fwd", 0),
    torch.bfloat16: ("flash_attention_fwd_tc", "mxtt_flash_attention_fwd_tc",
                     1),
    torch.float16: ("flash_attention_fwd_tc", "mxtt_flash_attention_fwd_tc",
                    2),
}
# the kernels' grid limits: batch * heads on x, Q tiles on y, d-chunks on z
_MAX_GRID = (2 ** 31 - 1, 65535, 65535)
# bf16/fp16's cluster kernels run any d above _WG_D, one block a
# _TC_CLUSTER_W-wide chunk and two 64-row Q tiles, clusters of at most
# _TC_CLUSTER_MAX blocks (CW, CL_MOST and ClusterTiles in
# csrc/flash_attention_fwd_tc.cu: 8, the portable cluster limit); fp32's
# cluster kernel any d above _WG_D, one block a _F32_CLUSTER_W-wide chunk
# of d and a 64-row Q tile, clusters of at most _F32_CLUSTER_MAX blocks,
# each keeping up to _F32_CLUSTER_QRES Q chunks (C_W, C_MAX and C_QRES in
# csrc/flash_attention_fwd.cu)
_TC_CLUSTER_W, _TC_CLUSTER_MAX, _TC_CLUSTER_ROWS = 192, 8, 128
_F32_CLUSTER_W, _F32_CLUSTER_MAX, _F32_CLUSTER_QRES = 128, 16, 4
# fp32 above _SPLIT_D runs, up to _WG_D, a kernel whose block owns all of d
# and two 64-row Q tiles, and the cluster kernel above; bf16/fp16 up to
# _WG_D run on wgmma at the smallest width of _WG_ROWS that holds d, its
# value the Q rows a block (Tiles<width> in csrc/flash_attention_fwd_tc.cu:
# 64-row consumer warpgroups, four at width 64, two at the others), with
# either producer, and the cluster kernels above
_SPLIT_D, _WG_D = 128, 256
_WG_ROWS = {64: 256, 128: 128, 192: 128, 256: 128}
_PLANS = ("flash_fwd_f32", "flash_fwd_f32_cluster", "flash_fwd_f32_wide",
          "flash_fwd_tc_cluster", "flash_fwd_tc_cluster_ldg",
          "flash_fwd_tc_wg", "flash_fwd_tc_wg_ldg")


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


def copy_bytes(d: int, *ptrs: int, itemsize: int = 4) -> int:
    """Width in bytes of a kernel's copies of one element group, for head
    dim ``d``, elements of ``itemsize`` bytes and the tensors' base
    addresses ``ptrs``: 16 (``cp.async`` of 16 bytes) when every row of
    ``d`` elements starts 16-byte aligned (``d * itemsize % 16 == 0`` and
    each base pointer a multiple of 16), else ``itemsize``. The fp32 kernel
    then copies 4 bytes with ``cp.async``; the tensor-core kernels (2-byte
    types) take such rows, which TMA refuses, through ``cp.async`` copies
    of their aligned 16-byte words and a shift in shared memory
    (``flash_fwd_tc_wg_ldg``, ``flash_fwd_tc_cluster_ldg``); with 16 they
    copy through TMA.
    A contiguous view at an offset of one element (``buf[1:].view(...)``)
    takes the narrow path."""
    aligned = d * itemsize % 16 == 0 and all(p % 16 == 0 for p in ptrs)
    return 16 if aligned else itemsize


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


def cluster_groups(d):
    """``(groups, blocks, chunks)`` of ``flash_fwd_f32_cluster`` at head dim
    ``d`` (``cluster_shape`` in csrc/flash_attention_fwd.cu): d splits
    into n = ceil(d / 128) chunks; up to 16 chunks one cluster of n
    blocks, above ceil(n / 16) groups of ceil(n / groups) blocks each.
    Block r of a group reduces the partial scores of chunks r, r + blocks,
    r + 2 blocks, ... (``chunks`` of them, those at or past n zero), so
    that every group computes S over all of d once, and block z of the
    grid's groups * blocks writes output chunk z (none past n)."""
    return _cluster_groups(-(-d // _F32_CLUSTER_W), _F32_CLUSTER_MAX)


def tc_cluster_groups(d):
    """``(groups, blocks, chunks)`` of ``flash_fwd_tc_cluster`` and
    ``flash_fwd_tc_cluster_ldg`` at head dim ``d`` > 256 (``cluster_shape``
    in csrc/flash_attention_fwd_tc.cu): :func:`cluster_groups`' rule at
    192-wide chunks and clusters of at most 8 blocks, the portable limit.
    Up to 8 chunks (d 1536) one cluster of n blocks; above, groups of 5-8
    blocks, block r of a group reducing the partial scores of chunks r, r +
    blocks, ... below n (at most ``chunks`` of them)."""
    return _cluster_groups(-(-d // _TC_CLUSTER_W), _TC_CLUSTER_MAX)


def _cluster_groups(n, most):
    """:func:`cluster_groups` of n chunks in clusters of at most ``most``
    blocks."""
    groups = -(-n // most)
    blocks = -(-n // groups)
    return groups, blocks, -(-n // blocks)


def _cluster_q_slots(chunks):
    """The Q chunks a block of ``flash_fwd_f32_cluster`` holds in shared
    memory when it reduces ``chunks`` chunks of d (``cluster_q_slots`` in
    csrc/flash_attention_fwd.cu): all of them where they fit, else a ring
    of two."""
    return chunks if chunks <= _F32_CLUSTER_QRES else 2


def launch_plan(dtype, batch, t_q, heads, d, copy=16):
    """``(kernel, width, grid)`` of a CUDA launch, as the C entries choose
    them for copies of ``copy`` bytes (:func:`copy_bytes`). bf16/fp16 up
    to d 256 run on wgmma at the smallest ``width`` of 64, 128, 192 and 256
    that holds d, on ``(batch * heads, blocks, 1)``: a block holds four
    adjacent 64-row Q tiles at width 64 (the last blocks' first, so the
    heaviest causal blocks start first), two adjacent ones at 128, and two
    at 192 and 256, tiles i and n - 1 - i, so that causal blocks carry
    equal work. 16-byte copies (what TMA needs) run ``flash_fwd_tc_wg``,
    2-byte ones ``flash_fwd_tc_wg_ldg``, the same consumers and grid fed
    by a producer that needs no TMA. Above 256 bf16/fp16 run clusters of
    blocks for each two 64-row Q tiles, i and n - 1 - i (width 192: each
    block a 192-wide chunk of d; ``flash_fwd_tc_cluster`` with 16-byte
    copies, ``flash_fwd_tc_cluster_ldg`` with 2-byte ones): up to d 1536
    one cluster of ceil(d / 192) blocks (8, the portable cluster limit),
    wider :func:`tc_cluster_groups`' groups of clusters, all their blocks
    on the grid's z. fp32 up to 128 runs the
    smallest instantiation (``width`` 32, 64 or 128) of ``flash_fwd_f32``
    that holds it, on ``(batch * heads, Q tiles, 1)`` (128-row Q tiles up
    to width 64, 64 above); from 129 to 256 all of d in one block of two
    64-row Q tiles (width 192 or 256, ``flash_fwd_f32_wide``, copies of 16
    or 4 bytes); above 256 clusters of blocks per 64-row Q tile, each block
    a 128-wide chunk of d (width 128, ``flash_fwd_f32_cluster``): up to d
    2048 one cluster of ceil(d / 128) blocks, wider :func:`cluster_groups`'
    groups of clusters, all their blocks on the grid's z. Raises where a
    grid dimension passes the card's limit (x < 2^31, y and z <= 65535)."""
    chunks = 1
    if dtype != torch.float32 and d <= _WG_D:
        name = "flash_fwd_tc_wg" if copy == 16 else "flash_fwd_tc_wg_ldg"
        width = min(w for w in _WG_ROWS if w >= d)
        rows = _WG_ROWS[width]
    elif dtype != torch.float32:
        name = ("flash_fwd_tc_cluster" if copy == 16
                else "flash_fwd_tc_cluster_ldg")
        width, rows = _TC_CLUSTER_W, _TC_CLUSTER_ROWS
        groups, blocks, _ = tc_cluster_groups(d)
        chunks = groups * blocks
    elif d <= _SPLIT_D:
        name = "flash_fwd_f32"
        width = 32 if d <= 32 else 64 if d <= 64 else 128
        rows = 128 if width <= 64 else 64
    elif d <= _WG_D:
        name = "flash_fwd_f32_wide"
        width, rows = 192 if d <= 192 else 256, 128
    else:
        name, width, rows = "flash_fwd_f32_cluster", _F32_CLUSTER_W, 64
        groups, blocks, _ = cluster_groups(d)
        chunks = groups * blocks
    grid = (batch * heads, -(-t_q // rows), chunks)
    for n, lim, what in zip(grid, _MAX_GRID,
                            ("batch * heads", "Q tiles", "d-chunks")):
        if n > lim:
            raise MXNetError(f"flash_attention: {what} {n} > {lim}, the "
                             "kernel grid's limit")
    return name, width, grid


def _check_cuda(q, k, v):
    if q.dtype not in _KERNELS:
        raise MXNetError(f"flash_attention: the CUDA kernels take float32, "
                         f"bfloat16 or float16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention: the CUDA kernel needs contiguous "
                         "q, k, v")


def entry(lib, name="mxtt_flash_attention_fwd"):
    """The C entry ``name`` of a loaded kernel library, typed for
    ``ctypes``. Both libraries' entries take (q, k, v, o, batch, t_q, t_k,
    heads, d, scale, causal, q_offset, dtype, copy_bytes, stream) and return
    a cudaError_t."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, scale, q_offset):
    from .. import _native

    lib, name, code = _KERNELS[q.dtype]
    b, t_q, h, d = q.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    copy = copy_bytes(d, *ptrs, itemsize=q.element_size())
    plan = launch_plan(q.dtype, b, t_q, h, d, copy)[0]
    fn = entry(_native.load(lib), name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b, t_q, k.shape[1], h, d, float(scale),
                 int(bool(causal)), int(q_offset), code, copy, stream)
    if err != 0:
        raise MXNetError(f"flash_attention: CUDA kernel launch failed "
                         f"(cudaError_t {err})")
    flash_attention.launches += 1
    flash_attention.launches_by_dtype[_dtype_name(q.dtype)] += 1
    flash_attention.launches_by_kernel[plan] += 1
    return out


def _forward(q, k, v, causal, scale, q_offset):
    """The forward routed by device: the CUDA kernel on the card (or raise),
    the plain version on the CPU, an empty result on ``meta``."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention: no kernel for device {q.device}")
    _check_cuda(q, k, v)
    if q.numel() == 0 or k.shape[1] == 0:
        raise MXNetError("flash_attention: empty q or k")
    return _launch(q, k, v, causal, scale, q_offset)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair: forward through :func:`_forward`,
    backward by recomputing attention in fp32 (``local_attention``,
    normalised by ``max(l, 1e-20)``, cast to q's dtype) and differentiating
    the recompute, as the reference's ``bwd`` does with ``jax.vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.attrs = (causal, scale, q_offset)
        return _forward(q, k, v, causal, scale, q_offset)

    @staticmethod
    def backward(ctx, g):
        causal, scale, q_offset = ctx.attrs
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_reference(*leaves, causal=causal,
                                            scale=scale, q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, block_q=128,
                    block_k=128, q_offset=0):
    """Attention over (B, T, H, D) without materializing (T, T) scores,
    differentiable in q, k and v.

    Same signature as the reference minus ``interpret``. ``block_q`` and
    ``block_k`` are the reference's tiling; the CUDA kernel uses its own
    tiles and the result does not depend on them."""
    _check(q, k, v, q_offset)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale),
                                 int(q_offset))


def reset_launches():
    """Set every launch count of :func:`flash_attention` to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = {
        _dtype_name(t): 0 for t in _KERNELS}
    flash_attention.launches_by_kernel = {name: 0 for name in _PLANS}


reset_launches()
