"""The tile sweep's variants (mxnet_tpu_torch/tools/flash_tile_sweep.py) are
patches of the committed kernel sources: each must still apply to them, as
many times as it says, so that a change to a kernel source that moves a
patch's anchor fails here and not on the card."""
import os

import pytest

from mxnet_tpu_torch import _native
from mxnet_tpu_torch.tools import flash_tile_sweep as sweep

CASES = [(kernel, name) for kernel, (_, variants, _, _) in
         sweep.KERNELS.items() for name in variants]


@pytest.mark.parametrize("kernel,name", CASES)
def test_sweep_variant_patches_the_committed_source(kernel, name):
    source, variants, make, _ = sweep.KERNELS[kernel]
    with open(os.path.join(_native.CSRC_DIR, source)) as f:
        src = f.read()
    out = make(src, *variants[name])   # raises where a patch misses
    if kernel != "f32" and not variants[name]:
        assert out == src
    elif kernel != "f32":
        assert out != src


def test_ldg_direct_variant_reads_device_memory_only():
    """The direct variant's shifts read the row's words from device memory
    and its producer copies nothing into the staging."""
    with open(os.path.join(_native.CSRC_DIR,
                           "flash_attention_fwd_tc.cu")) as f:
        src = f.read()
    out = sweep.wg_ldg_variant_source(src, *sweep.WG_LDG_VARIANTS["direct"])
    assert out.count("uint4 ldg128(uint64_t addr)") == 1
    assert "lds128(words" not in out
    assert "cp_async16_to(dst + r * L::RAW" not in out
    assert "ldg128(words + c * 128 + 16)" in out


def test_ldg_warps2_variant_returns_the_idle_warps():
    with open(os.path.join(_native.CSRC_DIR,
                           "flash_attention_fwd_tc.cu")) as f:
        src = f.read()
    out = sweep.wg_ldg_variant_source(src, *sweep.WG_LDG_VARIANTS["warps2"])
    assert "constexpr int LDG_THREADS = 64;" in out
    # once in each of the LDG route's loops (produce_ldg, ldg_pieces)
    assert out.count("if (t >= LDG_THREADS) return;") == 2


def test_sweep_diagnostics_are_variants_of_their_kernel():
    """Each kernel's diagnostics, the variants the sweep times without
    checking their results, are variants of that kernel, so that no other
    kernel's variant of the same name goes unchecked."""
    for kernel, names in sweep.DIAGNOSTICS.items():
        assert set(names) <= set(sweep.KERNELS[kernel][1]), kernel


def test_cluster_v2_variant_stages_v_from_the_start_of_a_tile():
    """The two-V-buffer variant of flash_fwd_f32_cluster copies V(n + 1)
    into buffer (n + 1) % 2 beside the copies the first step of tile n
    starts, reads tile n's V from buffer n % 2, waits for every copy group
    at the start of a step and for none before P V, and stages nothing at
    the end of a tile."""
    with open(os.path.join(_native.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    out = sweep.cluster_variant_source(src, *sweep.CLUSTER_VARIANTS["v2"])
    assert "(q_slots * C_BQ + 4 * C_BK)" in out
    assert "float* p_s = v_s + 2 * C_BK * DS;" in out
    assert out.count("v_s + ((kt + 1) & 1) * C_BK * DS, v_bh,") == 1
    assert out.count("if (u == 0 && kt + 1 < n_tiles)") == 1
    assert "v_s + (kt & 1) * C_BK * DS + (j + u) * DS" in out
    assert "cp_async_wait<1>" not in out
    assert out.count("cp_async_wait<0>();") == 1
    assert "(v_s, v_bh, k0 + C_BK," not in out
    assert "constexpr int C_BLOCKS = 1;" in out


def test_cluster_group_variants_patch_their_limits():
    """c8 caps flash_fwd_f32_cluster's clusters at the portable 8 blocks
    (groups of clusters from 9 chunks), qstream streams the Q chunks of
    every grouped block, and no_exchange keeps the cluster's size for the
    chunks a block reduces while it sums only its own partial."""
    with open(os.path.join(_native.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    make = sweep.cluster_variant_source
    assert "constexpr int C_MAX = 8;" in make(src, "c8")
    assert "constexpr int C_QRES = 1;" in make(src, "qstream")
    out = make(src, "no_exchange")
    assert "const uint32_t n_ranks = cluster_blocks();" in out
    assert "for (uint32_t r = 0; r < 1; ++r)" in out


def test_tc_cluster_variants_patch_the_exchange_and_the_chunks():
    """flash_fwd_tc_cluster's no_exchange diagnostic loads only from its
    own block's buffer (its rank in the cluster, in one cluster or in
    groups) and keeps the exchange's barriers; compute_alone calls no
    exchange at all, nor its last wait, in either form; c16 takes clusters
    of up to 16 blocks and allows the card's non-portable sizes past 8 on
    the kernel before it asks to place them; qstream2 streams the Q chunks
    of every grouped block. w256 takes 256-wide chunks, so clusters of 2-8
    blocks, with 64-row K/V tiles in two stages, the partials in pieces and
    the LDG route's smaller staging, and like the other variants whose
    tiles leave no room for a second Q slot it instantiates no groups of
    clusters (the sweep leaves out the cases past one cluster); form1 runs
    the one-cluster shapes on the groups' kernels."""
    with open(os.path.join(_native.CSRC_DIR,
                           "flash_attention_fwd_tc.cu")) as f:
        src = f.read()
    make = sweep.tc_cluster_variant_source
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["no_exchange"])
    assert "map_rank(mine, blockIdx.z % CL)" in out
    assert out.count("mbar_wait_cluster(full, round & 1);") == src.count(
        "mbar_wait_cluster(full, round & 1);")
    assert out.count("release_arrive_all_if<CL, true>(") == src.count(
        "release_arrive_all_if<CL, true>(")
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["compute_alone"])
    assert "xchg(sc, kt);" not in out and "xchg(sc, 0);" not in out
    assert "xchg.finish(n_tiles);" not in out
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["c16"])
    assert "constexpr int CL_MOST = 16;" in out
    assert "GL_MIN = CL_MOST / 2 + 1;" in out
    allow = out.index("cudaFuncAttributeNonPortableClusterSizeAllowed")
    assert out.index("allow_smem(kernel(), SMEM, smem_set);") < allow \
        < out.index("cluster_placeable(X::kernel(), config, placed)")
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["qstream2"])
    assert "constexpr int Q_KEEP = 1;" in out
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["w256"])
    assert "constexpr int CW = 256;" in out
    assert "CL_MIN = 256 / CW + 1;" in out
    assert "struct ClusterTiles : TilesOf<64, 2, 2, " in out
    assert "constexpr int XP_TMA = 2;" in out
    assert "constexpr int XP_LDG = 4;" in out
    assert "struct LdgTraits : LdgOf<16, 2, 40>" in out
    assert set(sweep.ONE_CLUSTER["tccluster"]) == {
        "w256", "w256_bk32", "bk64", "stages3", "stages4", "pingpong"}
    for name in sweep.ONE_CLUSTER["tccluster"]:
        out = make(src, *sweep.TC_CLUSTER_VARIANTS[name])
        assert "constexpr int GL_MIN = CL_MOST + 1;" in out, name
    out = make(src, *sweep.TC_CLUSTER_VARIANTS["form1"])
    assert "constexpr int GL_MIN = CL_MIN;" in out
    assert "at_shape(shape.blocks, 1," in out
