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
