"""The port's flash attention (mxnet_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernel run in interpret mode, on the same inputs
made with numpy. On the CPU the port's wrapper takes its plain version; the
CUDA kernel itself is held against that plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.flash_attention import flash_attention as jax_flash
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 2e-5, 2e-6   # the reference's own (tests/test_flash_attention.py)


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(q, k, v, **kw):
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True,
                     **kw)
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,block", [(16, 8), (32, 16)])
def test_plain_matches_pallas_interpret(causal, t, block):
    q, k, v = _inputs(0, [(2, t, 3, 8)] * 3)
    got, want = _both(q, k, v, causal=causal, block_q=block, block_k=block)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_q_offset_matches_pallas_interpret():
    """q_offset masks as for ring-attention K/V blocks
    (tests/test_flash_attention.py::test_flash_q_offset_matches_ring_blocks)."""
    q, k, v = _inputs(2, [(1, 8, 1, 4), (1, 16, 1, 4), (1, 16, 1, 4)])
    got, want = _both(q, k, v, causal=True, block_q=8, block_k=8, q_offset=8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_meta_tensors_give_shape_without_launch():
    before = tfa.flash_attention.launches
    q = torch.empty((2, 256, 4, 32), device="meta")
    k = torch.empty((2, 300, 4, 32), device="meta")
    out = tfa.flash_attention(q, k, k, causal=True)
    assert out.device.type == "meta"
    assert tuple(out.shape) == (2, 256, 4, 32) and out.dtype == q.dtype
    assert tfa.flash_attention.launches == before


def test_cpu_use_never_touches_library_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"library loader called for {name}")

    cuda_was_up = torch.cuda.is_initialized()
    monkeypatch.setattr(_native, "load", refuse)
    monkeypatch.setattr(_native, "build", refuse)
    before = tfa.flash_attention.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, [(1, 16, 2, 8)] * 3))
    tfa.flash_attention(q, k, v, causal=True)
    assert tfa.flash_attention.launches == before
    assert torch.cuda.is_initialized() == cuda_was_up


def test_bfloat16_output_keeps_q_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(4, [(1, 16, 2, 8)] * 3))
    out = tfa.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    want = tfa.flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2)


@pytest.mark.parametrize("bad", ["rank", "heads", "kv", "offset"])
def test_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros((1, 8, 2, 4))
    k = torch.zeros((1, 8, 2, 4))
    v = torch.zeros((1, 8, 2, 4))
    kw = {}
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = torch.zeros((1, 8, 3, 4))
    elif bad == "kv":
        v = torch.zeros((1, 9, 2, 4))
    else:
        kw["q_offset"] = -1
    with pytest.raises(MXNetError):
        tfa.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("flag,t_len,on_accel,want", [
    (None, 2048, True, True), (None, 2048, False, False),
    (None, 64, True, True), (None, 200, True, True),
    ("0", 2048, True, True), ("1", 32, False, False),
    ("1", 200, False, False),
])
def test_use_flash_rule(monkeypatch, flag, t_len, on_accel, want):
    """The kernel runs for every tensor on the card, whatever T and
    MXTPU_FLASH_ATTENTION (the reference's T % block rule exists only for
    its Pallas kernel); off the card the plain version runs."""
    if flag is None:
        monkeypatch.delenv("MXTPU_FLASH_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FLASH_ATTENTION", flag)
    assert tfa.use_flash(t_len, on_accel=on_accel) is want


@pytest.mark.parametrize("d,offset,want", [
    (64, 0, 16), (48, 0, 16), (128, 0, 16), (50, 0, 4), (33, 0, 4),
    (64, 1, 4), (64, 2, 4), (64, 4, 16), (32, 3, 4)])
def test_copy_bytes_rule(d, offset, want):
    """The fp32 kernel copies 16 bytes at a time only when every row of
    every tensor starts 16-byte aligned: d % 4 == 0 and aligned bases, so a
    contiguous view at a 4-byte offset takes the 4-byte copies."""
    buf = torch.zeros(2 * 5 * 3 * d + offset)
    x = buf[offset:].view(2, 5, 3, d)
    assert x.is_contiguous()
    aligned = torch.zeros((2, 5, 3, d))
    assert tfa.copy_bytes(d, x.data_ptr(), aligned.data_ptr()) == want
    assert tfa.copy_bytes(d, aligned.data_ptr()) == (16 if d % 4 == 0 else 4)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 16, ("flash_fwd_f32", 32, (6, 2, 1))),
    (torch.float32, 64, ("flash_fwd_f32", 64, (6, 2, 1))),
    (torch.float32, 100, ("flash_fwd_f32", 128, (6, 4, 1))),
    (torch.float32, 128, ("flash_fwd_f32", 128, (6, 4, 1))),
    # fp32 from 129 to 256: the wide kernel, all of d in one block of two
    # 64-row Q tiles (4 tiles of 200 rows: 2 blocks), widths 192 and 256
    (torch.float32, 129, ("flash_fwd_f32_wide", 192, (6, 2, 1))),
    (torch.float32, 160, ("flash_fwd_f32_wide", 192, (6, 2, 1))),
    (torch.float32, 192, ("flash_fwd_f32_wide", 192, (6, 2, 1))),
    (torch.float32, 200, ("flash_fwd_f32_wide", 256, (6, 2, 1))),
    (torch.float32, 256, ("flash_fwd_f32_wide", 256, (6, 2, 1))),
    # fp32 above 256: a cluster of ceil(d / 128) blocks a 64-row Q tile,
    # each a 128-wide chunk of d (the blocks on the grid's z), up to 16
    # blocks (d 2048); past 16 chunks groups of clusters of up to 16 blocks,
    # all on the grid's z (2049: two groups of 9; 4097: three of 11)
    (torch.float32, 300, ("flash_fwd_f32_cluster", 128, (6, 4, 3))),
    (torch.float32, 257, ("flash_fwd_f32_cluster", 128, (6, 4, 3))),
    (torch.float32, 320, ("flash_fwd_f32_cluster", 128, (6, 4, 3))),
    (torch.float32, 512, ("flash_fwd_f32_cluster", 128, (6, 4, 4))),
    (torch.float32, 1000, ("flash_fwd_f32_cluster", 128, (6, 4, 8))),
    (torch.float32, 1024, ("flash_fwd_f32_cluster", 128, (6, 4, 8))),
    (torch.float32, 1025, ("flash_fwd_f32_cluster", 128, (6, 4, 9))),
    (torch.float32, 1100, ("flash_fwd_f32_cluster", 128, (6, 4, 9))),
    (torch.float32, 2048, ("flash_fwd_f32_cluster", 128, (6, 4, 16))),
    (torch.float32, 2049, ("flash_fwd_f32_cluster", 128, (6, 4, 18))),
    (torch.float32, 4096, ("flash_fwd_f32_cluster", 128, (6, 4, 32))),
    (torch.float32, 4097, ("flash_fwd_f32_cluster", 128, (6, 4, 33))),
    # bf16/fp16 with 16-byte copies: the wgmma/TMA kernel at every d up to
    # 256, all of d in a block of four 64-row Q tiles at width 64 (the 4
    # tiles of 200 rows: 1 block) and of two at 128 and above (2 blocks)
    (torch.bfloat16, 64, ("flash_fwd_tc_wg", 64, (6, 1, 1))),
    (torch.bfloat16, 128, ("flash_fwd_tc_wg", 128, (6, 2, 1))),
    (torch.float16, 160, ("flash_fwd_tc_wg", 192, (6, 2, 1))),
    (torch.bfloat16, 256, ("flash_fwd_tc_wg", 256, (6, 2, 1))),
    (torch.bfloat16, 1000, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.bfloat16, 160, ("flash_fwd_tc_wg", 192, (6, 2, 1))),
    (torch.bfloat16, 192, ("flash_fwd_tc_wg", 192, (6, 2, 1))),
    (torch.bfloat16, 200, ("flash_fwd_tc_wg", 256, (6, 2, 1))),
    (torch.float16, 200, ("flash_fwd_tc_wg", 256, (6, 2, 1))),
    (torch.float16, 256, ("flash_fwd_tc_wg", 256, (6, 2, 1))),
    # from 257 to 1536: a cluster of ceil(d / 192) blocks for each two
    # 64-row Q tiles, each block a 192-wide chunk of d (on the grid's z),
    # 8 blocks (the portable limit) at the most; above, groups of clusters
    # (d 1537: 9 chunks, two groups of 5 blocks)
    (torch.bfloat16, 264, ("flash_fwd_tc_cluster", 192, (6, 2, 2))),
    (torch.bfloat16, 257, ("flash_fwd_tc_cluster", 192, (6, 2, 2))),
    (torch.float16, 257, ("flash_fwd_tc_cluster", 192, (6, 2, 2))),
    (torch.float16, 512, ("flash_fwd_tc_cluster", 192, (6, 2, 3))),
    (torch.bfloat16, 1024, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.float16, 1024, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.bfloat16, 1025, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.float16, 1025, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.bfloat16, 1152, ("flash_fwd_tc_cluster", 192, (6, 2, 6))),
    (torch.bfloat16, 1153, ("flash_fwd_tc_cluster", 192, (6, 2, 7))),
    (torch.float16, 1536, ("flash_fwd_tc_cluster", 192, (6, 2, 8))),
    (torch.bfloat16, 1537, ("flash_fwd_tc_cluster", 192, (6, 2, 10))),
    # d up to 64 at width 64, 65-128 at width 128 (columns past d zero)
    (torch.bfloat16, 32, ("flash_fwd_tc_wg", 64, (6, 1, 1))),
    (torch.bfloat16, 40, ("flash_fwd_tc_wg", 64, (6, 1, 1))),
    (torch.bfloat16, 96, ("flash_fwd_tc_wg", 128, (6, 2, 1))),
    (torch.bfloat16, 120, ("flash_fwd_tc_wg", 128, (6, 2, 1))),
    (torch.float16, 64, ("flash_fwd_tc_wg", 64, (6, 1, 1))),
    (torch.float16, 128, ("flash_fwd_tc_wg", 128, (6, 2, 1)))])
def test_launch_plan_by_head_dim(dtype, d, want):
    """Which kernel each head dim runs with 16-byte copies (t_q 200, batch
    2, heads 3): fp32 the smallest of the 32/64/128 instantiations up to
    128 and its wide kernel from 129 to 256; bf16/fp16 the wgmma/TMA kernel
    at the smallest of widths 64, 128, 192 and 256 that holds d; above 256
    clusters of blocks on the grid's z, each a 128-wide chunk of d in fp32
    (past 16 chunks in groups) and a 192-wide one in bf16/fp16 (past 8
    chunks in groups). fp32 Q tiles are 128 rows up to width 64, else
    64."""
    assert tfa.launch_plan(dtype, 2, 200, 3, d) == want
    assert tfa.launch_plan(dtype, 2, 200, 3, d, 16) == want


@pytest.mark.parametrize("dtype,d,copy,want", [
    (torch.float16, 160, 2, ("flash_fwd_tc_wg_ldg", 192, (6, 2, 1))),
    (torch.bfloat16, 200, 2, ("flash_fwd_tc_wg_ldg", 256, (6, 2, 1))),
    (torch.bfloat16, 256, 2, ("flash_fwd_tc_wg_ldg", 256, (6, 2, 1))),
    (torch.bfloat16, 130, 2, ("flash_fwd_tc_wg_ldg", 192, (6, 2, 1))),
    (torch.bfloat16, 1000, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 6))),
    (torch.bfloat16, 64, 2, ("flash_fwd_tc_wg_ldg", 64, (6, 1, 1))),
    (torch.float32, 256, 4, ("flash_fwd_f32_wide", 256, (6, 2, 1))),
    (torch.float32, 200, 4, ("flash_fwd_f32_wide", 256, (6, 2, 1))),
    (torch.float32, 130, 4, ("flash_fwd_f32_wide", 192, (6, 2, 1))),
    (torch.float32, 300, 4, ("flash_fwd_f32_cluster", 128, (6, 4, 3))),
    (torch.float32, 512, 4, ("flash_fwd_f32_cluster", 128, (6, 4, 4))),
    (torch.float32, 1100, 4, ("flash_fwd_f32_cluster", 128, (6, 4, 9))),
    (torch.float32, 2100, 4, ("flash_fwd_f32_cluster", 128, (6, 4, 18))),
    (torch.bfloat16, 128, 2, ("flash_fwd_tc_wg_ldg", 128, (6, 2, 1))),
    (torch.bfloat16, 50, 2, ("flash_fwd_tc_wg_ldg", 64, (6, 1, 1))),
    # odd d: 2-byte rows at every width
    (torch.bfloat16, 1, 2, ("flash_fwd_tc_wg_ldg", 64, (6, 1, 1))),
    (torch.bfloat16, 49, 2, ("flash_fwd_tc_wg_ldg", 64, (6, 1, 1))),
    (torch.float16, 97, 2, ("flash_fwd_tc_wg_ldg", 128, (6, 2, 1))),
    (torch.bfloat16, 129, 2, ("flash_fwd_tc_wg_ldg", 192, (6, 2, 1))),
    (torch.bfloat16, 255, 2, ("flash_fwd_tc_wg_ldg", 256, (6, 2, 1))),
    # 2-byte rows at d 129-256 (250: 500-byte rows)
    (torch.float16, 250, 2, ("flash_fwd_tc_wg_ldg", 256, (6, 2, 1))),
    (torch.bfloat16, 192, 2, ("flash_fwd_tc_wg_ldg", 192, (6, 2, 1))),
    # 2-byte rows above 256: the cluster kernel's LDG route, past 1536 in
    # groups of clusters
    (torch.bfloat16, 257, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 2))),
    (torch.float16, 320, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 2))),
    (torch.float16, 257, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 2))),
    (torch.bfloat16, 1024, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 6))),
    (torch.float16, 1023, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 6))),
    (torch.bfloat16, 1025, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 6))),
    (torch.float16, 1100, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 6))),
    (torch.bfloat16, 1535, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 8))),
    (torch.float16, 1537, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 10))),
    (torch.bfloat16, 1601, 2, ("flash_fwd_tc_cluster_ldg", 192, (6, 2, 10)))])
def test_launch_plan_by_copy_width(dtype, d, copy, want):
    """2-byte rows (what TMA refuses: d not a multiple of 8, or a base that
    is not 16-byte aligned) run flash_fwd_tc_wg_ldg up to d 256 and
    flash_fwd_tc_cluster_ldg above, at the TMA route's width and grid;
    fp32's 4-byte copies change no route: the wide and cluster kernels copy
    4 bytes at a time too."""
    assert tfa.launch_plan(dtype, 2, 200, 3, d, copy) == want


def test_launch_plan_wg_grid_pairs_q_tiles():
    """The wgmma/TMA kernel's grid: one block for each two 64-row Q tiles
    of a head at widths 128, 192 and 256 and each four at width 64 (a
    count that does not divide leaves the last block with fewer tiles),
    and its y capped like the other kernels'."""
    for d, width, tiles in ((256, 256, 2), (192, 192, 2), (128, 128, 2),
                            (96, 128, 2), (64, 64, 4), (32, 64, 4)):
        rows = 64 * tiles
        for t_q in (1, 64, 65, 128, 129, 192, 256, 257, 2048, 2049):
            assert tfa.launch_plan(torch.bfloat16, 2, t_q, 4, d) == (
                "flash_fwd_tc_wg", width, (8, -(-t_q // rows), 1))
        assert tfa.launch_plan(torch.float16, 1, rows * 65535, 1, d)[2][1] \
            == 65535
        with pytest.raises(MXNetError, match="Q tiles"):
            tfa.launch_plan(torch.bfloat16, 1, rows * 65535 + 1, 1, d)


@pytest.mark.parametrize("d", [256, 250, 192, 130, 128, 97, 64, 50, 1])
def test_launch_plan_ldg_route_takes_the_tma_grid(d):
    """2-byte rows up to d 256 run flash_fwd_tc_wg_ldg at the width and on
    the grid the TMA route takes for the same shape, capped alike."""
    width = min(w for w in (64, 128, 192, 256) if w >= d)
    for t_q in (1, 64, 65, 129, 257, 2049):
        for dtype in (torch.bfloat16, torch.float16):
            tma = tfa.launch_plan(dtype, 2, t_q, 4, 256 if d > 192 else
                                  192 if d > 128 else 128 if d > 64 else 64)
            assert tfa.launch_plan(dtype, 2, t_q, 4, d, 2) == (
                "flash_fwd_tc_wg_ldg", width, tma[2])
    rows = 256 if width == 64 else 128
    assert tfa.launch_plan(torch.bfloat16, 1, rows * 65535, 1, d,
                           2)[2][1] == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.bfloat16, 1, rows * 65535 + 1, 1, d, 2)


@pytest.mark.parametrize("d,width", [(129, 192), (192, 192), (256, 256)])
def test_launch_plan_f32_wide_grid_pairs_q_tiles(d, width):
    """fp32's wide kernel: one block for each two 64-row Q tiles of a head
    (tiles y and n - 1 - y; an odd count leaves the middle tile alone), at
    either copy width, and its y capped like the other kernels'."""
    for t_q, blocks in ((1, 1), (64, 1), (65, 1), (128, 1), (129, 2),
                        (192, 2), (2048, 16), (2049, 17), (2111, 17)):
        for copy in (16, 4):
            assert tfa.launch_plan(torch.float32, 2, t_q, 4, d, copy) \
                == ("flash_fwd_f32_wide", width, (8, blocks, 1))
    assert tfa.launch_plan(torch.float32, 1, 128 * 65535, 1, d)[2][1] \
        == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.float32, 1, 128 * 65535 + 1, 1, d)


@pytest.mark.parametrize("d,blocks", [(257, 3), (320, 3), (384, 3),
                                      (385, 4), (512, 4), (1000, 8),
                                      (1024, 8), (1025, 9), (1100, 9),
                                      (2048, 16), (2049, 18), (2100, 18),
                                      (4096, 32), (4097, 33), (8300, 65)])
def test_launch_plan_f32_cluster_grid(d, blocks):
    """fp32's cluster kernel: for each 64-row Q tile of a head one cluster
    of ceil(d / 128) blocks up to 16, past 16 chunks groups of clusters,
    all their blocks on the grid's z, at either copy width, and its y
    capped like the other kernels'."""
    for t_q, tiles in ((1, 1), (64, 1), (65, 2), (200, 4), (2048, 32),
                       (2049, 33)):
        for copy in (16, 4):
            assert tfa.launch_plan(torch.float32, 2, t_q, 4, d, copy) \
                == ("flash_fwd_f32_cluster", 128, (8, tiles, blocks))
    assert tfa.launch_plan(torch.float32, 1, 64 * 65535, 1, d)[2][1] \
        == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.float32, 1, 64 * 65535 + 1, 1, d)


@pytest.mark.parametrize("d,blocks", [(257, 2), (320, 2), (384, 2),
                                      (385, 3), (512, 3), (576, 3),
                                      (577, 4), (768, 4), (769, 5),
                                      (960, 5), (961, 6), (1024, 6),
                                      (1152, 6), (1153, 7), (1344, 7),
                                      (1345, 8), (1536, 8)])
def test_launch_plan_tc_cluster_grid(d, blocks):
    """bf16/fp16's cluster kernels: one cluster of ceil(d / 192) blocks for
    each two 64-row Q tiles of a head (tiles i and n - 1 - i, as
    flash_fwd_tc_wg's grid at widths 192 and 256), its blocks on the grid's
    z, the same grid at either copy width, and its y capped like the other
    kernels'."""
    for t_q, tiles in ((1, 1), (64, 1), (65, 1), (128, 1), (129, 2),
                       (200, 2), (2048, 16), (2049, 17)):
        for dtype in (torch.bfloat16, torch.float16):
            for copy, name in ((16, "flash_fwd_tc_cluster"),
                               (2, "flash_fwd_tc_cluster_ldg")):
                assert tfa.launch_plan(dtype, 2, t_q, 4, d, copy) \
                    == (name, 192, (8, tiles, blocks))
    assert tfa.launch_plan(torch.bfloat16, 1, 128 * 65535, 1, d)[2][1] \
        == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.float16, 1, 128 * 65535 + 1, 1, d, 2)


@pytest.mark.parametrize("batch,heads,ok", [
    (1, 65535, True), (16400, 4, True), (4100, 16, True),
    (2 ** 16, 2 ** 15 - 1, True), (2 ** 16, 2 ** 15, False)])
def test_launch_plan_batch_heads(batch, heads, ok):
    """batch * heads lies on the grid's x, whose limit is 2^31 - 1: 65 600
    heads are taken, 2^31 are refused."""
    if ok:
        grid = tfa.launch_plan(torch.float32, batch, 64, heads, 64)[2]
        assert grid[0] == batch * heads
    else:
        with pytest.raises(MXNetError, match="batch \\* heads"):
            tfa.launch_plan(torch.float32, batch, 64, heads, 64)


def test_launch_plan_q_tiles_and_chunks_capped():
    """Q tiles (grid y) and d-chunks (grid z) stay within 65535: bf16 at
    d 64 runs four 64-row Q tiles a block (256 rows) with either producer,
    its groups of clusters at d 1600 two; the groups of clusters of both
    put all their blocks on z."""
    for copy in (16, 2):
        assert tfa.launch_plan(torch.bfloat16, 1, 256 * 65535, 1, 64,
                               copy)[2][1] == 65535
        with pytest.raises(MXNetError, match="Q tiles"):
            tfa.launch_plan(torch.bfloat16, 1, 256 * 65535 + 1, 1, 64, copy)
    assert tfa.launch_plan(torch.bfloat16, 1, 128 * 65535, 1, 1600,
                           2)[2][1] == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.bfloat16, 1, 128 * 65535 + 1, 1, 1600, 2)
    # 65528 chunks of 192: 8191 groups of 8 blocks; 65529: 8192 groups of 8
    assert tfa.launch_plan(torch.float16, 1, 64, 1, 192 * 65528)[2][2] \
        == 65528
    with pytest.raises(MXNetError, match="d-chunks"):
        tfa.launch_plan(torch.float16, 1, 64, 1, 192 * 65528 + 1, 2)
    # 65520 chunks: 4095 groups of 16 blocks; 65521: 4096 groups of 16
    assert tfa.launch_plan(torch.float32, 1, 64, 1, 128 * 65520)[2][2] \
        == 65520
    with pytest.raises(MXNetError, match="d-chunks"):
        tfa.launch_plan(torch.float32, 1, 64, 1, 128 * 65520 + 1)
    with pytest.raises(MXNetError, match="d-chunks"):
        tfa.launch_plan(torch.float32, 1, 64, 1, 128 * 65535 + 1)


@pytest.mark.parametrize("d", [160, 192, 200, 256, 320, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_above_128_matches_pallas_interpret(monkeypatch, d, causal):
    """Head dims the CUDA path runs in its kernels that own all of d
    (fp32's wide kernel, bf16/fp16's wgmma/TMA one) and, at 320 and 512,
    in fp32's cluster of blocks that split d: the port's wrapper
    (its plain version on the CPU) against the JAX kernel in interpret mode,
    as the JAX package's own tests run it (T a multiple of its 128 block),
    with q_offset on the causal case."""
    monkeypatch.setenv("MXTPU_FLASH_ATTENTION", "1")
    q, k, v = _inputs(7, [(1, 128, 2, d), (1, 256, 2, d), (1, 256, 2, d)])
    kw = dict(causal=causal, q_offset=128 if causal else 0)
    got, want = _both(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _view_at_offset_one(a, dtype):
    """``a`` in ``dtype`` as a contiguous view one element into a buffer:
    its base is not 16-byte aligned, so the card takes its 2-byte route."""
    t = torch.from_numpy(a).to(dtype)
    buf = torch.zeros(t.numel() + 1, dtype=dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# fp32: the reference's own limits; bf16: both sides compute in fp32 (so
# they part by fp32's limits) and round to bf16 once, so they part by at
# most one step of bf16 more (2^-7 of the value)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, RTOL, ATOL),
                                             (torch.bfloat16, 2 ** -7, ATOL)])
@pytest.mark.parametrize("d", [49, 97, 250])
@pytest.mark.parametrize("causal", [False, True])
def test_rows_tma_refuses_match_pallas_interpret(dtype, rtol, atol, d,
                                                 causal):
    """Rows that TMA refuses (odd d, and views at an offset of one element)
    run flash_fwd_tc_wg_ldg on the card up to d 256 in bf16/fp16: the
    port's wrapper (its plain version on the CPU) on such views against the
    JAX kernel in interpret mode on the same values, with q_offset on the
    causal case."""
    q, k, v = _inputs(11, [(1, 128, 2, d), (1, 256, 2, d), (1, 256, 2, d)])
    tq, tk, tv = (_view_at_offset_one(a, dtype) for a in (q, k, v))
    assert tq.is_contiguous() and tq.data_ptr() % 16 != 0
    item = tq.element_size()
    copy = tfa.copy_bytes(d, tq.data_ptr(), tk.data_ptr(), tv.data_ptr(),
                          itemsize=item)
    assert copy == item
    if dtype == torch.bfloat16:
        assert tfa.launch_plan(dtype, 1, 128, 2, d, copy)[0] \
            == "flash_fwd_tc_wg_ldg"
    kw = dict(causal=causal, q_offset=128 if causal else 0)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    want = jax_flash(*(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for x in (tq, tk, tv)), interpret=True, **kw)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [257, 1024, 1025, 1100, 2048, 2049, 2100, 4096,
                               4097, 6144, 8192, 8193, 8300, 100000])
def test_cluster_groups_cover_every_chunk_once(d):
    """fp32's groups of clusters: at most 16 blocks a cluster; one cluster
    up to 16 chunks of d, and past them the fewest groups; in every group
    the blocks' chunks (rank r: r, r + blocks, ...) cover each chunk of d
    once, so S is computed once a group; the grid's groups * blocks output
    chunks cover the n of d, idle past n in fewer blocks than there are
    groups."""
    n = -(-d // 128)
    groups, blocks, chunks = tfa.cluster_groups(d)
    assert blocks <= 16 and groups == -(-n // 16)
    assert (groups == 1) == (n <= 16)
    covered = sorted(r + u * blocks for r in range(blocks)
                     for u in range(chunks))
    assert [c for c in covered if c < n] == list(range(n))
    assert n <= groups * blocks < n + groups


@pytest.mark.parametrize("d", [257, 1536, 1537, 1600, 2048, 3072, 3073, 3300,
                               8300, 100000])
def test_tc_cluster_groups_cover_every_chunk_once(d):
    """bf16/fp16's groups of clusters: at most 8 blocks a cluster (the
    portable limit); one cluster up to 8 chunks of 192 columns, and past
    them ceil(n / 8) groups; in every group the blocks' chunks (rank r: r,
    r + blocks, ...) cover each chunk of d once, so S is computed once a
    group; the grid's groups * blocks output chunks cover the n of d."""
    n = -(-d // 192)
    groups, blocks, chunks = tfa.tc_cluster_groups(d)
    assert blocks <= 8 and groups == -(-n // 8)
    assert (groups == 1) == (n <= 8) == (d <= 1536)
    assert groups > 1 or chunks == 1
    assert groups == 1 or blocks >= 5
    covered = sorted(r + u * blocks for r in range(blocks)
                     for u in range(chunks))
    assert [c for c in covered if c < n] == list(range(n))
    assert n <= groups * blocks < n + groups


@pytest.mark.parametrize("d,z", [(1537, 10), (1600, 10), (1601, 10),
                                 (2048, 12), (2304, 12), (2305, 14),
                                 (3072, 16), (3073, 18), (3300, 18),
                                 (8300, 48)])
def test_launch_plan_tc_cluster_groups_grid(d, z):
    """bf16/fp16 above d 1536: the cluster kernels' groups of clusters for
    each two 64-row Q tiles of a head, all their blocks (groups * blocks)
    on the grid's z, the same grid at either copy width, and its y capped
    like the other kernels'."""
    groups, blocks, _ = tfa.tc_cluster_groups(d)
    assert groups * blocks == z
    for t_q, tiles in ((1, 1), (128, 1), (129, 2), (2048, 16), (2049, 17)):
        for dtype in (torch.bfloat16, torch.float16):
            for copy, name in ((16, "flash_fwd_tc_cluster"),
                               (2, "flash_fwd_tc_cluster_ldg")):
                assert tfa.launch_plan(dtype, 2, t_q, 4, d, copy) \
                    == (name, 192, (8, tiles, z))
    assert tfa.launch_plan(torch.bfloat16, 1, 128 * 65535, 1, d)[2][1] \
        == 65535
    with pytest.raises(MXNetError, match="Q tiles"):
        tfa.launch_plan(torch.float16, 1, 128 * 65535 + 1, 1, d, 2)


def _group_schedule(q, k, v, causal, q_offset, width, most, block_k=32):
    """The schedule of the groups of clusters (flash_fwd_f32_cluster's,
    and flash_fwd_tc_cluster's past 8 chunks) in torch, at chunk width
    ``width`` and clusters of at most ``most`` blocks
    (:func:`cluster_groups`): for each group and K tile, block r's partial
    S over its chunks r, r + blocks, ... (zero past d) in order, the
    blocks' partials summed in rank order; then the online softmax of that
    S and P V for each output chunk of the group's blocks, normalised by
    the same l. S, m, l and O are fp32; with 16-bit inputs P is rounded to
    their type before P V, as the tensor-core kernels do, and the output
    is rounded to it. Checks that every group covers each chunk of d once
    and computes the same S bits, and that each output chunk is written
    once."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    n = -(-d // width)
    groups, blocks, chunks = tfa._cluster_groups(n, most)
    pad = groups * blocks * width - d
    qp, kp, vp = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))

    def cols(x, c):
        return x[..., c * width:(c + 1) * width]

    rows = q_offset + torch.arange(t_q)
    out = torch.zeros_like(qp)
    written = [0] * (groups * blocks)
    scores = []
    for g in range(groups):
        reduced = [r + u * blocks for r in range(blocks)
                   for u in range(chunks)]
        assert sorted(c for c in reduced if c < n) == list(range(n))
        outs = range(g * blocks, (g + 1) * blocks)
        m = torch.full((b, h, t_q), float("-inf"))
        l = torch.zeros(b, h, t_q)
        acc = {z: torch.zeros(b, h, t_q, width) for z in outs}
        group_scores = []
        for k0 in range(0, t_k, block_k):
            kt, vt = kp[:, k0:k0 + block_k], vp[:, k0:k0 + block_k]
            s = None
            for r in range(blocks):
                part = 0
                for u in range(chunks):
                    c = r + u * blocks
                    part = part + torch.einsum("bqhd,bkhd->bhqk",
                                               cols(qp, c), cols(kt, c))
                s = part if s is None else s + part
            group_scores.append(s)
            x = s * d ** -0.5
            if causal:
                keys = k0 + torch.arange(kt.shape[1])
                x = torch.where(rows[:, None] < keys[None, :],
                                torch.tensor(-1e30), x)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            p_v = p.to(dtype).float()   # P as P V takes it
            for z in outs:
                acc[z] = acc[z] * corr[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p_v, cols(vt, z))
        scores.append(group_scores)
        for z in outs:
            if z < n:
                o = acc[z] / l.clamp(min=1e-20)[..., None]
                out[..., z * width:(z + 1) * width] = o.transpose(1, 2)
                written[z] += 1
    assert all(torch.equal(a, b) for other in scores[1:]
               for a, b in zip(scores[0], other))
    assert written == [1] * n + [0] * (groups * blocks - n)
    return out[..., :d].to(dtype)


# d 64: one cluster of 4 chunks; 100: 7 chunks, two groups of 4 (chunk 7
# past d: rank 3 reduces chunks 3 and 7, output chunk 7 is idle); 150: 10
# chunks, three groups of 4. fp32 as flash_fwd_f32_cluster computes it;
# bf16 as the tensor-core cluster kernels do (P rounded to bf16 before P
# V), held at their limit on the card
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [64, 100, 150])
@pytest.mark.parametrize("causal", [False, True])
def test_group_schedule_matches_pallas_interpret(dtype, atol, d, causal):
    """The schedule of the groups of clusters, emulated in torch at
    16-wide chunks and clusters of at most 4 blocks, against the JAX
    kernel in interpret mode on the same inputs (rounded to ``dtype``),
    with q_offset on the causal case."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(
        13, [(1, 128, 2, d), (1, 256, 2, d), (1, 256, 2, d)]))
    kw = dict(causal=causal, q_offset=128 if causal else 0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_flash(*(jnp.asarray(x.float().numpy()).astype(jdt)
                                  for x in (q, k, v)),
                                interpret=True, **kw)).astype(np.float32)
    got = _group_schedule(q, k, v, width=16, most=4, **kw)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_plan_constants_match_the_kernel_sources():
    """The plan's chunk widths and cluster limits are the kernels' own."""
    def source(name):
        with open(os.path.join(_native.CSRC_DIR, name)) as f:
            return f.read()

    fp32 = source("flash_attention_fwd.cu")
    tc = source("flash_attention_fwd_tc.cu")
    assert f"constexpr int C_W = {tfa._F32_CLUSTER_W};" in fp32
    assert f"constexpr int C_MAX = {tfa._F32_CLUSTER_MAX};" in fp32
    assert f"constexpr int C_QRES = {tfa._F32_CLUSTER_QRES};" in fp32
    assert f"constexpr int CW = {tfa._TC_CLUSTER_W};" in tc
    assert f"constexpr int CL_MOST = {tfa._TC_CLUSTER_MAX};" in tc
