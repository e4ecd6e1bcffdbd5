"""`chip_smoke.py`'s kernel table bounds K1, K1b and K2 with the work that
`port_bench/flops/counts.py` counts, the one count the benchmark's rooflines
read, over the peak `chip_smoke.PEAK_FLOPS` names for the kernel's dtype.
Held here at the table's shapes in both dtypes, without a card, so that the
two cannot count different work again."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from port_bench.flops import counts  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]
# (b, l, heads) of the table's K1 entries at head width 64: the train step
# and serving at 170 rows, EF-CapTr's 256, an mp 2 rank's 6 heads
K1_SHAPES = [(48, 170, 12), (48, 256, 12), (48, 170, 6)]
# (frames, valid) of phase k2's cases: a batch's packed images (two
# invalid), its packed ROI crops (179 valid in the card's draw), raw uint8
# images
K2_CASES = {"packed_images": (56, 54), "packed_rois": (224, 179), "raw_u8_images": (56, 56)}


def test_the_peaks_are_the_tables_convention():
    """bf16 at the dense tensor-core rate the rooflines use; f32 as
    "tf32x3" takes it, three TF32 products for each f32 product; f32 on
    the CUDA cores."""
    assert chip_smoke.PEAK_FLOPS == {torch.bfloat16: 989e12, "tf32x3": 495e12 / 3,
                                     torch.float32: 67e12}
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == counts.PEAK_BF16
    assert chip_smoke.PEAK_FLOPS["tf32x3"] == counts.PEAK_TF32 / 3


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("backward", [False, True], ids=["k1", "k1b"])
@pytest.mark.parametrize("b,l,heads", K1_SHAPES)
def test_attention_bound_is_the_benchmarks_count(b, l, heads, backward, dtype):
    elt = torch.finfo(dtype).bits // 8
    work = (counts.k1_backward(b, l, heads * 64, heads, elt) if backward
            else counts.k1_forward(b, l, heads * 64, heads, elt, with_lse=False))
    got = chip_smoke.attention_bound(b, l, heads, 64, dtype, backward)
    assert (got["flops"], got["bytes"]) == (work["flop"], work["bytes"])
    peak = chip_smoke.PEAK_FLOPS["tf32x3" if dtype == torch.float32 else dtype]
    assert got["bound_ms"] == counts.bound_s(work, peak) * 1e3
    by_bytes = work["bytes"] / counts.HBM_BYTES_S >= work["flop"] / peak
    assert got["bound_by"] == ("bytes" if by_bytes else "operations")
    if dtype == torch.float32:
        assert got["cuda_cores_bound_ms"] == counts.bound_s(work, 67e12) * 1e3
    else:
        assert "cuda_cores_bound_ms" not in got


def test_backward_bytes_at_the_train_step():
    """K1b at [48, 170, 768] in bf16: q, k, v, g read and dq, dk, dv
    written, the f32 mask row and the [48, 12, 170] f32 logsumexp read."""
    got = chip_smoke.attention_bound(48, 170, 12, 64, torch.bfloat16, backward=True)
    assert got["bytes"] == 7 * 48 * 170 * 768 * 2 + 4 * 48 * 170 + 4 * 48 * 12 * 170 == 88_160_640


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", list(K2_CASES))
def test_pixels_bound_is_the_benchmarks_count(case, dtype):
    frames, valid = K2_CASES[case]
    work = counts.k2_unpack(frames, valid, 224, torch.finfo(dtype).bits // 8)
    got = chip_smoke.pixels_bound(frames, valid, dtype)
    assert (got["flops"], got["bytes"]) == (work["flop"], work["bytes"])
    assert got["bound_ms"] == counts.bound_s(work, 67e12) * 1e3
    assert got["bound_by"] == "bytes"
