"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. This file imports no JAX, so it runs on a machine with only PyTorch
(``--noconftest`` skips the JAX set-up in tests/conftest.py):

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_kernels.py

Without a CUDA device each test skips."""
import pytest
import torch

from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import flash_attention as tfa


def _at_offset(x, offset):
    """``x`` copied into a contiguous view ``offset`` elements into a
    buffer: at offset 1 (4 bytes in fp32, 2 in bf16 and fp16) its base is
    not 16-byte aligned."""
    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.gpu
# fp16 is held between its own reading and the bf16 kernel's (1.1e-3 and
# 8.1e-3 at the LM's shape), so an fp16 path at bf16's precision fails
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 3e-3)])
@pytest.mark.parametrize("causal,q_offset,t_q,t_k,d,offset", [
    (True, 0, 256, 256, 64, 0), (True, 64, 200, 264, 64, 0),
    (False, 0, 100, 70, 32, 0), (True, 0, 128, 128, 128, 0),
    # edges of the fp32 kernel's tiles (128 Q rows, 64 at D=128; 32 K/V
    # rows): t_q below one Q tile, T not a multiple of the tiles, t_k > t_q
    # with q_offset, d in {32, 50, 64, 128}
    (True, 0, 37, 37, 64, 0), (False, 0, 37, 101, 64, 0),
    (True, 0, 300, 300, 32, 0), (True, 100, 150, 250, 64, 0),
    (True, 64, 200, 264, 50, 0), (False, 0, 130, 190, 50, 0),
    (True, 0, 257, 257, 128, 0), (True, 5, 70, 75, 128, 0),
    # contiguous views at an offset of one element: the 4-byte copy path
    # in fp32, the element-wise path of the tensor-core kernel
    (True, 0, 200, 200, 64, 1), (False, 0, 100, 70, 48, 1),
    (True, 16, 90, 106, 128, 1),
    # edges of the tensor-core kernel's tiles (64 Q rows, 16 a warp; 64
    # K/V rows): t_q below one warp's rows, T not a multiple of 64, t_k >
    # t_q with q_offset, d in {16, 48, 80} (50 and 128 above), and d = 50
    # with an offset of 1 element
    (True, 0, 1, 1, 64, 0), (True, 0, 5, 5, 64, 0), (False, 0, 5, 70, 32, 0),
    (True, 0, 65, 65, 64, 0), (False, 0, 127, 127, 64, 0),
    (True, 0, 127, 127, 128, 0), (True, 130, 60, 190, 64, 0),
    (True, 0, 100, 100, 16, 0), (True, 3, 96, 99, 48, 0),
    (False, 0, 150, 150, 80, 0), (True, 0, 70, 70, 50, 1),
    # head dims above 128: fp32's wide kernel (all of d in a block of two
    # 64-row Q tiles, widths 192 and 256; 160 and 200 zero-filled past d);
    # bf16/fp16's wgmma/TMA kernel (the same blocks; 160 and 200 end in a
    # partial 64-wide box, filled with zeros by TMA), causal and not,
    # ragged T, with q_offset; 130 (rows not 16-byte aligned in 16 bits)
    # and views at an offset of one element: fp32's 4-byte copies, the
    # tensor-core kernel's LDG producer
    (True, 32, 100, 132, 160, 0), (False, 16, 90, 70, 160, 0),
    (True, 0, 129, 129, 200, 0), (False, 8, 64, 77, 200, 0),
    (True, 64, 130, 194, 256, 0), (False, 0, 70, 140, 256, 0),
    (True, 0, 100, 100, 130, 0), (True, 0, 70, 70, 200, 1),
    (True, 5, 33, 38, 256, 1),
    # d = 192 (the 192-wide instantiation), and t_q above two Q tiles: odd
    # and even tile counts pair tiles i and n - 1 - i across blocks
    (True, 0, 200, 200, 192, 0), (False, 3, 77, 150, 192, 0),
    (True, 0, 333, 333, 256, 0), (True, 40, 300, 340, 160, 0),
    (False, 0, 520, 390, 256, 0),
    # t_q above two Q tiles with q_offset: an even tile count (4, 8, the
    # last at a 4-byte offset) and an odd one (5, 9); 300, wider than 256,
    # on each dtype's cluster kernel
    (True, 24, 256, 280, 256, 0), (True, 7, 450, 457, 200, 1),
    (True, 13, 270, 283, 256, 1), (True, 64, 520, 584, 192, 0),
    (True, 0, 150, 150, 300, 0), (False, 9, 100, 130, 300, 0),
    # bf16/fp16 with 16-byte rows up to 128 on the wgmma/TMA kernel (width
    # 64: blocks of four 64-row Q tiles, 64-row K/V tiles; width 128: two
    # Q tiles, 128-row K/V tiles): d 32, 40 and 96 (a 64-element box over
    # fewer columns reads zeros past d), t_q below one Q tile, odd and even
    # tile counts a block (5-8 tiles), t_k > t_q with q_offset, non-causal;
    # and d 64 at an offset of one element, which stays on flash_fwd_tc
    (True, 0, 40, 40, 96, 0), (False, 0, 50, 90, 96, 0),
    (True, 0, 90, 90, 40, 0), (True, 0, 448, 448, 64, 0),
    (True, 0, 512, 512, 64, 0), (True, 0, 384, 384, 128, 0),
    (True, 0, 320, 320, 128, 0), (True, 50, 300, 350, 32, 0),
    (True, 77, 333, 410, 96, 0), (False, 0, 300, 200, 128, 0),
    (False, 0, 260, 260, 64, 0), (False, 0, 150, 170, 64, 1),
    # rows TMA refuses on the wgmma kernel's LDG producer (bf16/fp16):
    # views at an offset of one element at widths 192 and 256 (64 and 128
    # above), more Q tiles than a block takes at width 64, odd d at every
    # width (1, 33, 97, 255), d 250 (500-byte rows), ragged T with
    # q_offset, non-causal
    (True, 0, 300, 300, 160, 1), (False, 0, 300, 300, 255, 1),
    (True, 0, 513, 513, 64, 1), (True, 0, 1, 1, 1, 0),
    (True, 0, 257, 257, 33, 0), (False, 0, 129, 129, 97, 0),
    (True, 64, 200, 264, 97, 0), (True, 9, 333, 342, 250, 0)])
def test_cuda_kernel_matches_plain(dtype, tol, causal, q_offset, t_q, t_k, d,
                                   offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (_at_offset(torch.randn((2, t, 3, d), generator=g,
                                      device="cuda").to(dtype), offset)
               for t in (t_q, t_k, t_k))
    item = q.element_size()
    aligned = d * item % 16 == 0 and not offset
    assert tfa.copy_bytes(d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          itemsize=item) == (16 if aligned else item)
    before = tfa.flash_attention.launches
    plan = tfa.launch_plan(dtype, 2, t_q, 3, d, 16 if aligned else item)[0]
    by_kernel = tfa.flash_attention.launches_by_kernel[plan]
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    # the kernel of the route: bf16/fp16 up to d 256 run the wgmma kernel,
    # flash_fwd_tc_wg with 16-byte rows, flash_fwd_tc_wg_ldg with the
    # others, and above its clusters, flash_fwd_tc_cluster and
    # flash_fwd_tc_cluster_ldg; fp32 runs flash_fwd_f32 up to 128,
    # flash_fwd_f32_wide (either copy width) from 129 to 256 and
    # flash_fwd_f32_cluster above
    assert tfa.flash_attention.launches_by_kernel[plan] == by_kernel + 1
    if dtype == torch.float32:
        route = ("flash_fwd_f32" if d <= 128 else "flash_fwd_f32_wide"
                 if d <= 256 else "flash_fwd_f32_cluster")
    else:
        route = "flash_fwd_tc_cluster" if d > 256 else "flash_fwd_tc_wg"
        route += "" if aligned else "_ldg"
    assert plan == route
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal, q_offset=q_offset)
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("batch,t_q,t_k,heads,d,causal,q_offset,offset", [
    # d 320 (three 128-wide chunks, the last half empty) and 512 (four),
    # causal and not, at T above one Q tile
    (2, 300, 300, 2, 320, True, 0, 0), (2, 300, 300, 2, 320, False, 0, 0),
    (2, 260, 260, 2, 512, True, 0, 0), (2, 200, 333, 2, 512, False, 0, 0),
    # ragged d (columns past d zero in the last chunk), d 1000 and 1024
    # (clusters of 8 blocks), d 257 (the narrowest)
    (2, 190, 190, 3, 300, True, 0, 0), (2, 150, 150, 2, 500, True, 0, 0),
    (2, 130, 130, 1, 1000, True, 0, 0), (1, 70, 70, 1, 1024, False, 0, 0),
    (2, 129, 129, 2, 257, True, 0, 0),
    # views at an offset of one element: 4-byte copies
    (2, 200, 200, 2, 512, True, 0, 1), (2, 77, 90, 3, 1024, True, 13, 1),
    (1, 100, 100, 2, 767, False, 0, 1),
    # batch 1; ragged T with q_offset; t_q of 1 and below one Q tile
    (1, 256, 256, 2, 512, True, 0, 0), (1, 200, 264, 2, 512, True, 64, 0),
    (1, 100, 180, 2, 320, False, 9, 0), (2, 1, 1, 3, 384, True, 0, 0),
    (2, 1, 40, 2, 512, True, 39, 0), (2, 33, 33, 2, 640, True, 0, 0),
    # above 1024: clusters of 9-16 blocks (1100, 2048), and past 16 chunks
    # groups of clusters: 2100 (two groups of 9, a ragged last chunk and
    # an idle 18th block), also at 4-byte copies with q_offset, 4097
    # (three of 11, Q chunks kept), 8300 (five of 13, Q chunks streamed)
    (2, 65, 65, 2, 1100, True, 0, 0), (1, 70, 70, 1, 2048, False, 0, 0),
    (1, 130, 130, 1, 2100, True, 0, 0), (2, 77, 90, 1, 2100, True, 13, 1),
    (1, 100, 100, 1, 4097, False, 0, 0), (1, 70, 70, 1, 8300, True, 0, 0)])
def test_f32_cluster_matches_plain(batch, t_q, t_k, heads, d, causal,
                                   q_offset, offset):
    """fp32 head dims above 256 on flash_fwd_f32_cluster (past 16 chunks
    in groups of clusters), each launch counted by exact name, held to the
    plain version within 1e-4; the blocks of a cluster sum their partial
    scores in rank order, so a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(d + t_q)
    q, k, v = (_at_offset(torch.randn((batch, t, heads, d), generator=g,
                                      device="cuda"), offset)
               for t in (t_q, t_k, t_k))
    copy = tfa.copy_bytes(d, q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert copy == (4 if offset or d % 4 else 16)
    plan = tfa.launch_plan(torch.float32, batch, t_q, heads, d, copy)
    assert plan[0] == "flash_fwd_f32_cluster"
    groups, blocks, _ = tfa.cluster_groups(d)
    assert plan[2][2] == groups * blocks >= -(-d // 128)
    counts = tfa.flash_attention.launches_by_kernel
    before = counts[plan[0]]
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    again = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert counts[plan[0]] == before + 2
    want = tfa.flash_attention_reference(q, k, v, causal=causal,
                                         q_offset=q_offset)
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 3e-3)])
@pytest.mark.parametrize("batch,t_q,t_k,heads,d,causal,q_offset,offset", [
    # d 320 (two 192-wide chunks, the second 128 columns of d), 512 and
    # 1000 (three and six chunks, zero past d in the last), causal and not,
    # at T above a block's two Q tiles; d 264 and 1024 near the range's
    # ends, and 768 (four chunks)
    (2, 300, 300, 2, 320, True, 0, 0), (2, 300, 300, 2, 320, False, 0, 0),
    (2, 260, 260, 2, 512, True, 0, 0), (2, 200, 333, 2, 512, False, 0, 0),
    (2, 130, 130, 1, 1000, True, 0, 0), (1, 70, 70, 1, 1000, False, 0, 0),
    (2, 129, 129, 2, 264, True, 0, 0), (1, 64, 64, 1, 1024, True, 0, 0),
    (2, 65, 65, 3, 768, True, 0, 0),
    # rows TMA refuses, on the LDG producer: views at an offset of one
    # element (d 257, the narrowest, among them), and d 300 and 767 (rows
    # not 16-byte aligned)
    (2, 300, 300, 2, 320, True, 0, 1), (2, 200, 333, 2, 512, False, 0, 1),
    (2, 77, 90, 3, 1000, True, 13, 1), (1, 100, 100, 2, 767, False, 0, 0),
    (2, 190, 190, 3, 300, True, 0, 0), (1, 130, 130, 1, 257, False, 0, 1),
    # batch 1; ragged T with q_offset; t_q of 1 and below one Q tile
    (1, 256, 256, 2, 512, True, 0, 0), (1, 200, 264, 2, 512, True, 64, 0),
    (1, 100, 180, 2, 320, False, 9, 0), (2, 1, 1, 3, 384, True, 0, 0),
    (2, 1, 40, 2, 512, True, 39, 0), (2, 33, 33, 2, 640, True, 0, 0),
    (1, 200, 264, 2, 1000, True, 64, 1),
    # 1100 (6 blocks), 1344 and 1200 (7), 1400 and 1536 (8, the portable
    # limit), both routes; above 1536 groups of clusters, each computing S
    # once: 1600 (two groups of 5, block 9 without an output chunk, the
    # last rank reducing one chunk), both routes, 2048 (two of 6), 3072
    # (two of 8, the widest that keeps its Q chunks), 3300 at a small T
    # (three of 6, Q streamed beside K), and 2-byte rows above 1536 (1601,
    # and 1600 at an offset of one element)
    (2, 65, 65, 2, 1100, True, 0, 0), (2, 65, 65, 2, 1100, True, 0, 1),
    (1, 130, 130, 1, 1344, True, 0, 0), (2, 77, 90, 1, 1200, False, 13, 1),
    (1, 130, 130, 1, 1400, True, 0, 0), (1, 70, 90, 1, 1536, True, 20, 1),
    (2, 65, 65, 2, 1600, True, 0, 0), (1, 70, 70, 1, 1600, False, 0, 1),
    (1, 200, 264, 1, 2048, True, 64, 0), (2, 130, 130, 1, 3072, True, 0, 0),
    (1, 70, 70, 1, 3300, True, 0, 0), (1, 100, 130, 1, 3300, False, 0, 1),
    (1, 129, 129, 2, 1601, True, 0, 0)])
def test_tc_cluster_matches_plain(dtype, tol, batch, t_q, t_k, heads, d,
                                  causal, q_offset, offset):
    """bf16/fp16 head dims above 256 on flash_fwd_tc_cluster (16-byte rows)
    and flash_fwd_tc_cluster_ldg (the others), past 1536 in groups of
    clusters, each launch counted by exact name, held to the fp32 plain
    version on the same inputs at the 16-bit limits; the blocks of a
    cluster sum their partial scores in rank order, so a second run gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(d + t_q)
    q, k, v = (_at_offset(torch.randn((batch, t, heads, d), generator=g,
                                      device="cuda").to(dtype), offset)
               for t in (t_q, t_k, t_k))
    copy = tfa.copy_bytes(d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          itemsize=2)
    assert copy == (2 if offset or d % 8 else 16)
    plan = tfa.launch_plan(dtype, batch, t_q, heads, d, copy)
    assert plan[0] == ("flash_fwd_tc_cluster" if copy == 16 else
                       "flash_fwd_tc_cluster_ldg")
    groups, blocks, _ = tfa.tc_cluster_groups(d)
    assert plan[2][2] == groups * blocks >= -(-d // 192)
    assert (groups > 1) == (d > 1536)
    counts = tfa.flash_attention.launches_by_kernel
    before = dict(counts)
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    again = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in counts.items() if c != before[n]} \
        == {plan[0]: 2}
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal, q_offset=q_offset)
    assert got.dtype == dtype
    assert float((got.float() - want).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 3e-3)])
def test_batch_heads_above_65535(dtype, tol):
    """batch * heads lies on the grid's x (limit 2^31 - 1): 65 600 heads
    run in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((16400, 9, 4, 16), generator=g,
                           device="cuda").to(dtype) for _ in range(3))
    assert tfa.launch_plan(dtype, 16400, 9, 4, 16)[2][0] == 65600
    got = tfa.flash_attention(q, k, v, causal=True, q_offset=3)
    torch.cuda.synchronize()
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=True, q_offset=3)
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 3e-3)])
def test_batch_heads_above_65535_on_the_ldg_route(dtype, tol):
    """65 600 heads in one launch of the LDG producer's kernel (views at an
    offset of one element)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_at_offset(torch.randn((16400, 9, 4, 16), generator=g,
                                      device="cuda").to(dtype), 1)
               for _ in range(3))
    assert tfa.launch_plan(dtype, 16400, 9, 4, 16, 2) == (
        "flash_fwd_tc_wg_ldg", 64, (65600, 1, 1))
    before = tfa.flash_attention.launches_by_kernel["flash_fwd_tc_wg_ldg"]
    got = tfa.flash_attention(q, k, v, causal=True, q_offset=3)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches_by_kernel["flash_fwd_tc_wg_ldg"] \
        == before + 1
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=True, q_offset=3)
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("causal,q_offset,t_q,t_k", [
    (True, 0, 300, 300), (True, 40, 200, 240), (False, 0, 130, 333)])
def test_ldg_route_bit_identical_to_tma(dtype, d, causal, q_offset, t_q,
                                        t_k):
    """The LDG producer writes the bytes TMA would have: on views at an
    offset of one element it gives the same bits as flash_fwd_tc_wg on
    aligned copies of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (_at_offset(torch.randn((2, t, 3, d), generator=g,
                                      device="cuda").to(dtype), 1)
               for t in (t_q, t_k, t_k))
    counts = tfa.flash_attention.launches_by_kernel
    before = dict(counts)
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = tfa.flash_attention(q.clone(), k.clone(), v.clone(),
                               causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert counts["flash_fwd_tc_wg_ldg"] == before["flash_fwd_tc_wg_ldg"] + 1
    assert counts["flash_fwd_tc_wg"] == before["flash_fwd_tc_wg"] + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,causal,q_offset,t_q,t_k", [
    # one cluster (d 320, 1536) and groups of clusters (1600: two of 5;
    # 2048: two of 6; 3304: three of 6, Q streamed)
    (320, True, 0, 300, 300), (1536, False, 0, 130, 130),
    (1600, True, 40, 200, 240), (2048, False, 0, 130, 333),
    (3304, True, 0, 70, 70)])
def test_cluster_ldg_route_bit_identical_to_tma(dtype, d, causal, q_offset,
                                                t_q, t_k):
    """The cluster kernels' LDG producer writes the bytes TMA would have, in
    one cluster and in groups of clusters: on views at an offset of one
    element it gives the same bits as flash_fwd_tc_cluster on aligned
    copies of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (_at_offset(torch.randn((1, t, 2, d), generator=g,
                                      device="cuda").to(dtype), 1)
               for t in (t_q, t_k, t_k))
    counts = tfa.flash_attention.launches_by_kernel
    before = dict(counts)
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    want = tfa.flash_attention(q.clone(), k.clone(), v.clone(),
                               causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in counts.items()
            if c != before[n]} == {"flash_fwd_tc_cluster_ldg": 1,
                                   "flash_fwd_tc_cluster": 1}
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_launches_counted_by_dtype():
    """A bf16 and an fp16 launch count in the per-dtype counter beside the
    total; an fp32 launch in its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; runs on the card")
    tfa.reset_launches()
    for dtype in (torch.bfloat16, torch.float16, torch.float16,
                  torch.float32):
        q = torch.randn((1, 80, 2, 64), device="cuda").to(dtype)
        tfa.flash_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == 4
    assert tfa.flash_attention.launches_by_dtype == {
        "float32": 1, "bfloat16": 1, "float16": 2}


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


# -- gradients: the flash autograd.Function and the fused CE head -------------

def _grad_of(fn, inputs, head):
    xs = [x.detach().requires_grad_() for x in inputs]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, head)


def _max_rel(got, want):
    """Largest difference over the largest entry of ``want``."""
    return float((got.float().cpu() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.gpu
# the gradient is the same fp32 recompute on both devices, cast to the
# input's type: fp32 to summation order; a 16-bit gradient may round one
# step of its type apart (2^-8 of bf16's largest entries, 2^-11 of fp16's)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2),
                                       (torch.float16, 2e-3)])
@pytest.mark.parametrize("d", [64, 97, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_gradient_on_card_matches_cpu(dtype, tol, d, causal):
    """The flash Function on the card (forward: the kernel of the route,
    counted once, at d 200 and 256 fp32's wide kernel, bf16/fp16's wgmma
    kernel at every d, through TMA or, at the odd d 97, the LDG producer;
    backward: the fp32 recompute, which launches nothing) against the same
    Function on the CPU (plain forward, same recompute)."""
    g = _cuda()
    q, k, v, head = (torch.randn((2, 160, 3, d), generator=g, device="cuda")
                     .to(dtype) for _ in range(4))
    before = tfa.flash_attention.launches
    item = q.element_size()
    copy = tfa.copy_bytes(d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          itemsize=item)
    plan = tfa.launch_plan(dtype, 2, 160, 3, d, copy)[0]
    if dtype == torch.float32 and d > 128:
        assert plan == "flash_fwd_f32_wide"
    if dtype != torch.float32:
        assert plan == ("flash_fwd_tc_wg" if d % 8 == 0
                        else "flash_fwd_tc_wg_ldg")
    by_kernel = tfa.flash_attention.launches_by_kernel[plan]
    fn = lambda *a: tfa.flash_attention(*a, causal=causal)  # noqa: E731
    out, grads = _grad_of(fn, (q, k, v), head)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert tfa.flash_attention.launches_by_kernel[plan] == by_kernel + 1
    want_out, want = _grad_of(fn, [x.cpu() for x in (q, k, v)], head.cpu())
    assert all(x.dtype == dtype and x.is_cuda for x in grads)
    fwd_tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2,
               torch.float16: 3e-3}[dtype]
    assert float((out.float().cpu() - want_out.float()).abs().max()) \
        <= fwd_tol
    for got_g, want_g in zip(grads, want):
        assert _max_rel(got_g, want_g) <= tol


@pytest.mark.gpu
# fp32: summation order (TF32 is off for matmuls by default); bf16: each
# logit rounds to bf16 after sums in another order, as between the CPU and
# the JAX package (tests/test_torch_training.py sets the same limits)
@pytest.mark.parametrize("dtype,nll_tol,grad_tol", [
    (torch.float32, 1e-4, 1e-4), (torch.bfloat16, 3e-2, 1.5e-2)])
@pytest.mark.parametrize("vocab,chunk", [(1000, 256), (4096, 2048)])
def test_fused_head_on_card_matches_cpu(dtype, nll_tol, grad_tol, vocab,
                                        chunk):
    """FusedCrossEntropyHead's NLL and dx, dw, db on the card against the
    CPU, a ragged vocabulary among them."""
    from mxnet_tpu_torch import ops as tops

    assert not torch.backends.cuda.matmul.allow_tf32
    g = _cuda()
    n, h = 512, 128
    x = torch.randn((n, h), generator=g, device="cuda").to(dtype)
    w = (torch.randn((vocab, h), generator=g, device="cuda") * 0.1).to(dtype)
    b = (torch.randn((vocab,), generator=g, device="cuda") * 0.1).to(dtype)
    label = torch.randint(0, vocab, (n,), generator=g, device="cuda").float()
    label[::7] = -1
    attrs = {"num_classes": vocab, "chunk_size": chunk, "use_ignore": True,
             "ignore_label": -1, "normalization": "valid"}
    op = tops.get_op("FusedCrossEntropyHead")

    def fn(x, w, b):
        return op.fn(tops.OpCtx(), attrs, x, w, b, label.to(x.device))

    nll, grads = _grad_of(fn, (x, w, b), torch.ones(n, device="cuda"))
    torch.cuda.synchronize()
    want_nll, want = _grad_of(fn, [t.cpu() for t in (x, w, b)],
                              torch.ones(n))
    assert nll.dtype == torch.float32 and bool(torch.isfinite(nll).all())
    assert float((nll.cpu() - want_nll).abs().max()) <= nll_tol
    for got_g, want_g in zip(grads, want):
        assert got_g.dtype == dtype
        assert _max_rel(got_g, want_g) <= grad_tol


# -- runtime-compiled user kernels (mxnet_tpu_torch.rtc) ---------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and NVRTC; runs on the card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(512, 384), (1000003,)])
def test_rtc_axpy_cuda_kernel_exact(dtype, shape):
    """axpy through CudaKernel equals its plain version exactly (one
    rounding of 2x + y either way), at a ragged size too."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    tdt = getattr(torch, dtype)
    x = torch.randn(shape, generator=g, device="cuda").to(tdt)
    y = torch.randn(shape, generator=g, device="cuda").to(tdt)
    k = ex.axpy_kernel(dtype)
    out = k.push([mx.nd.NDArray(x), mx.nd.NDArray(y)])
    torch.cuda.synchronize()
    assert k.launches == 1
    assert out.context == mx.gpu(0) and out.dtype == tdt
    assert out.shape == tuple(shape)
    assert torch.equal(out.data, ex.axpy_reference(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (3,), (7,), (1000003,),
                                   (4096, 32768)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rtc_axpy_exact_any_n_and_offset(dtype, shape, offset):
    """The vector axpy on its own launch (a thread a 16-byte vector)
    equals 2x + y exactly for any n, and for inputs viewed at an offset of
    one element (4 bytes in fp32, 2 in bf16), where the output, aligned,
    does not share their alignment and the scalar loop runs."""
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    tdt = getattr(torch, dtype)
    x, y = (_at_offset(torch.randn(shape, generator=g, device="cuda")
                       .to(tdt), offset) for _ in range(2))
    k = ex.axpy_kernel(dtype)
    out = k(x, y)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert torch.equal(out, ex.axpy_reference(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 7, 1000003])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_rtc_axpy_head_vectors_tail(dtype, n, offset):
    """x, y and o all at one offset: the scalar head up to the 16-byte
    boundary, the vectors and the scalar tail together write every element
    once, exactly."""
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    tdt = getattr(torch, dtype)
    x, y = (_at_offset(torch.randn(n, generator=g, device="cuda").to(tdt),
                       offset) for _ in range(2))
    o = _at_offset(torch.full((n,), float("nan"), device="cuda").to(tdt),
                   offset)
    head, vectors, tail = ex.axpy_split(n, x.data_ptr(), y.data_ptr(),
                                        o.data_ptr(), x.element_size())
    assert head == min(n, (16 - offset * x.element_size()) // x.element_size())
    assert head + vectors * 16 // x.element_size() + tail == n
    k = ex.axpy_kernel(dtype)
    launcher = k._program.launcher(k.source, x.device, 4)
    grid, block = ex.axpy_dims(n, x.element_size())
    launcher([x.data_ptr(), y.data_ptr(), o.data_ptr(), n], grid, block)
    torch.cuda.synchronize()
    assert torch.equal(o, ex.axpy_reference(x, y))


@pytest.mark.gpu
def test_rtc_explicit_grid_and_block():
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    x = torch.randn(100003, generator=g, device="cuda")
    y = torch.randn(100003, generator=g, device="cuda")
    k = ex.axpy_kernel()
    for grid, block in (((7,), (128,)), ((1, 1, 1), (1024, 1, 1)),
                        ((4000,), (32,))):
        out = k(x, y, grid_dims=grid, block_dims=block)
        torch.cuda.synchronize()
        assert torch.equal(out, ex.axpy_reference(x, y))
    assert k.launches == 3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rtc_sgd_mom_matches_op(dtype):
    """The Rtc SGD-momentum kernel against the sgd_mom_update op body: bit
    for bit in fp32 (contraction off, same rounding points); in bf16 within
    one bf16 rounding of the fp32 math on the same rounded inputs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    tdt = getattr(torch, dtype)
    w, gr, m = (torch.randn((3000, 257), generator=g, device="cuda").to(tdt)
                for _ in range(3))
    w_nd, m_nd = mx.nd.NDArray(w.clone()), mx.nd.NDArray(m.clone())
    k = ex.sgd_mom_rtc(gr, w_nd, m_nd)
    res = k.push([mx.nd.NDArray(gr)], [w_nd, m_nd])
    torch.cuda.synchronize()
    assert res == [w_nd, m_nd] and k.launches == 1
    if dtype == "float32":
        want_w, want_m = ex.sgd_mom_reference(w, gr, m)
        assert torch.equal(w_nd.data, want_w)
        assert torch.equal(m_nd.data, want_m)
    else:
        want_w, want_m = ex.sgd_mom_reference(w.float(), gr.float(),
                                              m.float())
        for got, want in ((w_nd.data, want_w), (m_nd.data, want_m)):
            err = (got.float() - want).abs()
            assert bool((err <= 2 ** -8 * want.abs() + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rtc_axpy_as_rtc_body(dtype):
    """The same axpy as an MXNet-form Rtc body over in-place outputs."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    tdt = getattr(torch, dtype)
    x = torch.randn(70001, generator=g, device="cuda").to(tdt)
    y = torch.randn(70001, generator=g, device="cuda").to(tdt)
    o = mx.nd.NDArray(torch.empty_like(x))
    body = """
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < o_size)
    o[i] = mx_from_float<o_t>(2.0f * mx_to_float(x[i]) + mx_to_float(y[i]));
"""
    k = mx.rtc.Rtc("axpy_rtc", [("x", x), ("y", y)], [("o", o)], body)
    k.push([x, y], [o])
    torch.cuda.synchronize()
    assert torch.equal(o.data, ex.axpy_reference(x, y))


@pytest.mark.gpu
def test_rtc_errors_raise():
    """A compile error carries the NVRTC log; a refused launch carries its
    CUresult; a CPU or strided tensor is refused before launch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    _cuda()
    x = torch.ones(1000, device="cuda")
    bad = mx.rtc.CudaKernel(
        "bad", 'extern "C" __global__ void bad(const float* x, float* o, '
        'long long n) { o[0] = no_such_name; }')
    with pytest.raises(mx.MXNetError, match="no_such_name"):
        bad(x)
    unnamed = mx.rtc.CudaKernel(
        "mangled", '__global__ void mangled(const float* x, float* o, '
        'long long n) {}')
    with pytest.raises(mx.MXNetError, match="mangled"):
        unnamed(x)
    k = ex.axpy_kernel()
    with pytest.raises(mx.MXNetError, match="CUDA_ERROR_INVALID_VALUE"):
        k(x, x, block_dims=(2048,))
    with pytest.raises(mx.MXNetError, match="only on the card"):
        k(x.cpu(), x.cpu())
    with pytest.raises(mx.MXNetError, match="contiguous"):
        k(x.reshape(10, 100).t(), x.reshape(10, 100).t())
    assert k.launches == 0


@pytest.mark.gpu
def test_custom_op_pushes_cuda_kernel():
    """A CustomOp whose forward pushes the axpy CudaKernel, imperatively
    and in a one-op Symbol through Executor.forward, on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    g = _cuda()
    kern = ex.axpy_kernel()

    class Axpy(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], kern.push(in_data))

    @mx.operator.register("cuda_axpy_test")
    class AxpyProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["x", "y"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Axpy()

    x = torch.randn((64, 33), generator=g, device="cuda")
    y = torch.randn((64, 33), generator=g, device="cuda")
    want = ex.axpy_reference(x, y)
    out = mx.nd.Custom(mx.nd.NDArray(x), mx.nd.NDArray(y),
                       op_type="cuda_axpy_test")
    assert torch.equal(out.data, want) and kern.launches == 1
    sym = mx.sym.Custom(mx.sym.Variable("x"), mx.sym.Variable("y"),
                        op_type="cuda_axpy_test")
    ex_ = sym.bind(mx.gpu(0), {"x": mx.nd.NDArray(x),
                               "y": mx.nd.NDArray(y)})
    (res,) = ex_.forward()
    torch.cuda.synchronize()
    assert torch.equal(res.data, want) and kern.launches == 2


# -- index and cast ops on the card: the CPU's results, no device assert ----

def _specials():
    return torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9,
                         -3e9, 2.7, -2.7, 2147483520.0, -2147483648.0, 0.0])


@pytest.mark.gpu
@pytest.mark.parametrize("name,attrs,make", [
    ("Cast", {"dtype": "int32"}, lambda: [_specials()]),
    ("Cast", {"dtype": "uint8"}, lambda: [_specials()]),
    ("Cast", {"dtype": "int32"}, lambda: [_specials().half()]),
    ("sign", {}, lambda: [_specials()]),
    ("one_hot", {"depth": 4},
     lambda: [torch.tensor([float("nan"), 1.0, 5.0, -1.0, 3e9])]),
    ("take", {}, lambda: [torch.arange(12.0).reshape(4, 3),
                          torch.tensor([-1.0, 5, 1, -4, -5, 4, float("nan"),
                                        3e9])]),
    ("take", {"axis": 1}, lambda: [torch.arange(12.0).reshape(4, 3),
                                   torch.tensor([-1.0, 3, -4, 2])]),
    ("take", {}, lambda: [torch.arange(12, dtype=torch.int32).reshape(4, 3),
                          torch.tensor([-1.0, 5, 1, -5])]),
    ("batch_take", {}, lambda: [torch.arange(12.0).reshape(4, 3),
                                torch.tensor([-1.0, 5, float("nan"), -7])]),
    ("Embedding", {"input_dim": 4, "output_dim": 3},
     lambda: [torch.tensor([[float("nan"), -1.0, 4.0], [2.0, -5.0, 0.0]]),
              torch.arange(12.0).reshape(4, 3)]),
    ("topk", {"k": 2}, lambda: [torch.tensor([[0.0, 1, 1, 0, 1, 0]])]),
    ("topk", {"k": 2, "ret_typ": "mask", "is_ascend": True},
     lambda: [torch.tensor([[0.0, 1, 1, 0, 1, 0]])]),
])
def test_index_and_cast_ops_match_cpu(name, attrs, make):
    """Out-of-range, negative and NaN indices, and float-to-int casts of
    NaN, infinities and values past int32, give on the card what the port
    gives on the CPU (held to the JAX package by tests/test_torch_nd_ops.py
    and tests/test_torch_ops.py), and end in no device-side assert."""
    from mxnet_tpu_torch import ops as tops

    _cuda()
    inputs = make()
    op = tops.get_op(name)
    want = op.fn(tops.OpCtx(device=torch.device("cpu")), dict(attrs),
                 *inputs)
    got = op.fn(tops.OpCtx(device=torch.device("cuda")), dict(attrs),
                *(t.cuda() for t in inputs))
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.is_floating_point():
        assert torch.equal(got.cpu().isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(want))


# -- the ResNet ops (Convolution through cuDNN, Pooling, BatchNorm) ----------

def _tied_relu(g):
    """A ReLU output with 2x2 windows of zeros (tied maxima)."""
    x = torch.randn((2, 3, 8, 8), generator=g, device="cuda").relu()
    x[:, :, 0:2, 0:2] = 0.0
    x[:, :, 2:4, 4:6] = 0.0
    return x


_RESNET_OP_CASES = [
    ("Convolution", dict(kernel=(3, 3), num_filter=6, pad=(1, 1)),
     [(2, 4, 9, 9), (6, 4, 3, 3), (6,)], True),
    ("Convolution", dict(kernel=(3, 3), num_filter=6, stride=(2, 2),
                         no_bias=True), [(2, 4, 9, 9), (6, 4, 3, 3)], True),
    ("Convolution", dict(kernel=(3, 3), num_filter=6, pad=(2, 2),
                         dilate=(2, 2)), [(2, 4, 9, 9), (6, 4, 3, 3), (6,)],
     True),
    ("Convolution", dict(kernel=(1, 1), num_filter=6, num_group=2,
                         stride=(2, 2)), [(2, 4, 9, 9), (6, 2, 1, 1), (6,)],
     True),
    ("Convolution", dict(kernel=(3, 3), num_filter=6, pad=(1, 1),
                         stride=(2, 2), layout="NHWC"),
     [(2, 9, 9, 4), (6, 3, 3, 4), (6,)], True),
    ("Convolution", dict(kernel=(7, 7), num_filter=64, pad=(3, 3),
                         stride=(2, 2), no_bias=True),
     [(4, 3, 64, 64), (64, 3, 7, 7)], True),
    ("Pooling", dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1)), [(2, 3, 9, 9)], True),
    ("Pooling", dict(pool_type="avg", kernel=(2, 2), stride=(2, 2),
                     pad=(1, 1), pooling_convention="full"), [(2, 3, 5, 5)],
     True),
    ("Pooling", dict(pool_type="sum", kernel=(3, 3), stride=(1, 1),
                     pad=(1, 1)), [(2, 3, 7, 7)], True),
    ("Pooling", dict(pool_type="avg", global_pool=True, kernel=(7, 7)),
     [(2, 3, 7, 7)], True),
    ("Pooling", dict(pool_type="max", kernel=(3, 3), stride=(2, 2),
                     pad=(1, 1), layout="NHWC"), [(2, 9, 9, 3)], True),
    ("Pooling", dict(pool_type="max", kernel=(2, 2), stride=(2, 2)),
     [_tied_relu], True),
    ("BatchNorm", dict(fix_gamma=False, eps=2e-5), [(4, 3, 5, 5), (3,), (3,)],
     True),
    ("BatchNorm", dict(fix_gamma=True, eps=2e-5), [(4, 3, 5, 5), (3,), (3,)],
     True),
    ("BatchNorm", dict(fix_gamma=False), [(4, 3, 5, 5), (3,), (3,)], False),
    ("BatchNorm", dict(fix_gamma=False, axis=3, momentum=0.8),
     [(4, 5, 5, 3), (3,), (3,)], True),
    ("BatchNorm", dict(fix_gamma=False, eps=2e-5),
     [(32, 64, 28, 28), (64,), (64,)], True),
]


@pytest.mark.gpu
# fp32 with TF32 off: summation order; bf16: each output rounds to bf16
# after sums in another order (tests/test_torch_resnet.py holds both to the
# JAX package at the same limits)
@pytest.mark.parametrize("dtype,out_tol,grad_tol",
                         [(torch.float32, 1e-5, 1e-4),
                          (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("name,attrs,shapes,is_train", _RESNET_OP_CASES,
                         ids=[f"{c[0]}{i}" for i, c in
                              enumerate(_RESNET_OP_CASES)])
def test_resnet_ops_on_card_match_cpu(name, attrs, shapes, is_train, dtype,
                                      out_tol, grad_tol, monkeypatch):
    """Convolution (cuDNN), Pooling and BatchNorm on the card against the
    CPU: the output, its dtype, the new moving statistics and the gradient
    of every input for one random head gradient."""
    from mxnet_tpu_torch import ops as tops

    g = _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    inputs = [s(g) if callable(s) else
              torch.randn(s, generator=g, device="cuda") for s in shapes]
    if name == "BatchNorm":
        inputs[1] = inputs[1] + 1.0
        aux = [torch.randn((shapes[1][0],), generator=g, device="cuda") * 0.1,
               torch.rand((shapes[1][0],), generator=g, device="cuda") + 0.5]
    else:
        aux = []
    op = tops.get_op(name)
    head = None

    def run(device):
        nonlocal head
        xs = [x.detach().to(device).requires_grad_() for x in inputs]
        (out,), new_aux = op.normalized_call(
            tops.OpCtx(is_train=is_train, device=torch.device(device)),
            dict(attrs), [x.to(dtype) for x in xs],
            [a.to(device) for a in aux])
        if head is None:
            head = torch.randn(out.shape, generator=g, device="cuda")
        grads = torch.autograd.grad(out, xs, head.to(device, out.dtype),
                                    allow_unused=True)
        return out.detach(), new_aux, grads

    got, got_aux, got_grads = run("cuda")
    torch.cuda.synchronize()
    want, want_aux, want_grads = run("cpu")
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert _max_rel(got, want) <= out_tol
    for a, b in zip(got_aux, want_aux):
        assert a.dtype == torch.float32 and _max_rel(a, b) <= 1e-5
    for a, b in zip(got_grads, want_grads):
        if b is None:
            assert a is None
        else:
            assert _max_rel(a, b) <= grad_tol


# ---------------------------------------------------------------------------
# io.DevicePrefetchIter: pinned staging on a side stream


class _HostBatches:
    """``n`` host batches of (data, label) made from one numpy seed, and
    the numpy arrays they hold."""

    def __init__(self, n, shape=(64, 3, 32, 32)):
        import numpy as np

        import mxnet_tpu_torch as mx

        rng = np.random.default_rng(0)
        self.arrays = [(rng.standard_normal(shape, dtype=np.float32),
                        rng.integers(0, 10, shape[0]).astype(np.float32))
                       for _ in range(n)]
        self.batch_size = shape[0]
        self.provide_data = [mx.io.DataDesc("data", shape)]
        self.provide_label = [mx.io.DataDesc("softmax_label", shape[:1])]
        self.cursor = 0
        self._mx = mx

    def reset(self):
        self.cursor = 0

    def next(self):
        if self.cursor == len(self.arrays):
            raise StopIteration
        x, y = self.arrays[self.cursor]
        self.cursor += 1
        mx = self._mx
        return mx.io.DataBatch([mx.nd.array(x, mx.cpu())],
                               [mx.nd.array(y, mx.cpu())])


def _fc_module(mx, shape):
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(mx.sym.Variable("data")), num_hidden=10, name="fc"),
        name="softmax")
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", shape[:1])])
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_orders_copies_before_use(depth):
    """Batches staged on the side stream while the consumer's stream is
    held back by a long kernel: each batch read on the consumer's stream
    equals its host arrays, through a ring of depth + 1 pinned slots
    reused many times, and the consumer's stream waited for each copy."""
    import numpy as np

    import mxnet_tpu_torch as mx

    _cuda()
    src = _HostBatches(12)
    mod = _fc_module(mx, (64, 3, 32, 32))
    it = mod.device_prefetch(src, depth=depth)
    main = torch.cuda.current_stream()
    sums = []
    for _ in range(len(src.arrays)):
        torch.cuda._sleep(2_000_000)   # the step the copy overlaps
        batch = it.next()
        data, label = batch.data[0].data, batch.label[0].data
        assert data.is_cuda and label.is_cuda
        sums.append((data.double().sum(), (label * 2).clone()))
        del batch, data, label   # freed while the stream still reads them
    with pytest.raises(StopIteration):
        it.next()
    main.synchronize()
    for (s, lab), (x, y) in zip(sums, src.arrays):
        assert float(s) == pytest.approx(float(x.astype(np.float64).sum()),
                                         rel=1e-12)
        np.testing.assert_array_equal(lab.cpu().numpy(), y * 2)
    assert it.h2d_bytes == sum(x.nbytes + y.nbytes for x, y in src.arrays)
    it.reset()
    first = it.next().data[0].asnumpy()
    np.testing.assert_array_equal(first, src.arrays[0][0])
    it.close()


@pytest.mark.gpu
def test_pinned_ring_waits_for_a_slot_copy():
    """A slot is refilled only after its copy's event: with two slots and
    the side stream held by a long kernel, the third stage blocks until
    the first copy ran, and every device copy holds its own host data."""
    from mxnet_tpu_torch.io import PinnedRing

    _cuda()
    ring = PinnedRing(torch.device("cuda", 0), 2)
    with torch.cuda.stream(ring.stream):
        torch.cuda._sleep(50_000_000)
    host = [torch.full((1 << 20,), float(i)) for i in range(5)]
    staged = []
    for h in host:
        (dev,), event = ring.stage([h])
        staged.append((dev, event))
    for i, (dev, event) in enumerate(staged):
        event.synchronize()
        assert bool((dev == float(i)).all())


@pytest.mark.gpu
def test_fit_with_device_prefetch_is_bit_identical_on_card(monkeypatch):
    """Three epochs of ResNet-8 through ``fit`` with and without
    ``MXNET_DEVICE_PREFETCH=1`` from one seed, deterministic cuDNN: equal
    parameters and aux states, bit for bit."""
    import numpy as np

    import mxnet_tpu_torch as mx

    _cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 3, 16, 16), dtype=np.float32)
    y = (np.arange(64) % 10).astype(np.float32)
    got = []
    for prefetch in ("0", "1"):
        monkeypatch.setenv("MXNET_DEVICE_PREFETCH", prefetch)
        mx.random.seed(3)
        mod = mx.mod.Module(mx.models.resnet.get_symbol(10, 8, "3,16,16"),
                            context=mx.gpu(0))
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=16), num_epoch=3,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier())
        args, aux = mod.get_params()
        got.append({n: a.asnumpy() for n, a in {**args, **aux}.items()})
    for n in got[0]:
        np.testing.assert_array_equal(got[0][n], got[1][n], err_msg=n)
