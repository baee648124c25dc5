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
    assert out.count("if (t >= LDG_THREADS) return;") == 1


def test_sweep_diagnostics_are_variants_of_their_kernel():
    """Each kernel's diagnostics, the variants the sweep times without
    checking their results, are variants of that kernel, so that no other
    kernel's variant of the same name goes unchecked."""
    for kernel, names in sweep.DIAGNOSTICS.items():
        assert set(names) <= set(sweep.KERNELS[kernel][1]), kernel


def test_cluster_v2_variant_stages_v_from_the_start_of_a_tile():
    """The two-V-buffer variant of flash_fwd_f32_cluster copies V(n + 1)
    into buffer (n + 1) % 2 behind K(n + 1), reads tile n's V from buffer
    n % 2, waits for all but two copy groups before P V, and stages nothing
    at the end of a tile."""
    with open(os.path.join(_native.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    out = sweep.cluster_variant_source(src, *sweep.CLUSTER_VARIANTS["v2"])
    assert "(C_BQ + 4 * C_BK)" in out
    assert "float* p_s = v_s + 2 * C_BK * DS;" in out
    assert out.count("v_s + ((kt + 1) & 1) * C_BK * DS, v_bh,") == 1
    assert "v_s + (kt & 1) * C_BK * DS + (j + u) * DS" in out
    assert "cp_async_wait<2>();" in out
    assert "(v_s, v_bh, k0 + C_BK," not in out
    assert "constexpr int C_BLOCKS = 1;" in out
