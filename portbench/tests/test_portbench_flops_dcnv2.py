"""The reference's FLOP count of DLRM-DCNv2, worked out by hand from the
configuration's widths, and the row bytes the K1/K2 rooflines count."""

import json
import os

from portbench import flops
from portbench.reference import dlrm_dcnv2 as model

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(HERE, "configs", "dcnv2_criteo1tb.json")) as f:
    CFG = json.load(f)


def test_flops_from_the_widths():
    bottom = 2 * (13 * 512 + 512 * 256 + 256 * 128)
    D = 128 + 26 * 128
    assert D == 3456
    cross = 3 * 2 * (D * 512 + 512 * D)      # V_l then W_l, 3 layers
    top = 2 * (D * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    assert cross == 21_233_664 and cross // 2 == 10_616_832
    assert model.cross_flops_per_example(CFG) == cross
    assert model.forward_flops_per_example(CFG) == bottom + cross + top \
        == 32_060_928
    assert model.train_flops_per_example(CFG) == 3 * 32_060_928 \
        == 96_182_784


def test_row_bytes_of_the_rooflines():
    # flops.py counts a 1-wide bias the rows do not have: 1028 B for the
    # 1024 B of [vector 128 | accumulator 128] f32, 0.4% over
    assert flops.row_state_bytes(CFG) == 1028
    assert flops.row_kernel_bytes(1000, CFG) == 2_056_000
