"""The kernel-variant scripts' substitutions against the sources they edit.

`k1_variants`, `k2_variants`, `k3_variants`, `k4_variants`, `k6_variants`
and `k8_variants` time copies of `csrc/warp_corr.cu`, `csrc/vis_net.cu`,
`csrc/depth_decode.cu`, `csrc/encoder_head.cu`, `csrc/gsa_attention.cu` and
`csrc/warp_corr_bwd.cu` with lines substituted; they run only on a GPU. (`k4_variants`' and
`k6_variants`' `PARENT_VARIANTS` edit an earlier tree's source, which they
are given on the command line.) Here,
on the CPU, every variant's lines must still be found in today's source
(else the script raises before it builds anything) and must change it,
and the ptxas report's parser must name the kernels as the scripts print
them.
"""

import pytest

from mvsformer_torch import (k1_variants, k2_variants, k3_variants, k4_variants, k6_variants,
                             k8_variants)
from mvsformer_torch.kernel_variants import ptxas_summary, variant_source
from mvsformer_torch.ops import cuda_build

CASES = [("warp_corr", name, subs) for name, subs in k1_variants.VARIANTS.items()] + \
        [("vis_net", name, subs) for name, subs in k2_variants.VARIANTS.items()] + \
        [("depth_decode", name, subs) for name, subs in k3_variants.VARIANTS.items()] + \
        [("encoder_head", name, subs) for name, subs in k4_variants.VARIANTS.items()] + \
        [("gsa_attention", name, subs) for name, subs in k6_variants.VARIANTS.items()] + \
        [("warp_corr_bwd", name, subs) for name, subs in k8_variants.VARIANTS.items()]


@pytest.mark.parametrize("lib,name,subs", CASES, ids=[f"{c[0]}: {c[1]}" for c in CASES])
def test_variant_lines_are_in_the_source(lib, name, subs):
    source = (cuda_build.CSRC / f"{lib}.cu").read_text()
    variant = variant_source(lib, subs)
    assert (variant == source) == (name == "as built")


def test_variant_source_raises_on_a_missing_line():
    with pytest.raises(RuntimeError, match="not found"):
        variant_source("warp_corr", [("no such line;", "")])


def test_ptxas_summary_names_kernels_and_counts():
    report = (
        "ptxas info    : Compiling entry function "
        "'_ZN49_GLOBAL__N__456efab1_16_warp_corr_0_0_cu_eddda59722warp_group_corr_kernel"
        "ILi64ELb1EEEvPKfS2_S2_S2_PfS3_iiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 54 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z11pack_kernelPKfS0_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, 16384 bytes smem, 400 bytes cmem[0]\n")
    assert ptxas_summary(report) == [("warp_group_corr_kernel<64,1>", 54, 8, 0),
                                     ("pack_kernel", 32, 0, 16384)]
