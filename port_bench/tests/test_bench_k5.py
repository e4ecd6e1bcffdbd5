"""The readers of K5's kernels in the device trace (`metrics/k5_*`): each
counts K5's two kernel names and nothing else, per traced step or batch,
and finds nothing (None, no raise) in a trace without K5, as a program
whose ResNet runs every block on its modules gives."""

import pytest

from port_bench.lib.bench import Files
from port_bench.lib.trace import Trace

from conftest import BENCH

READERS = ("k5_launches.serve", "k5_launches.train", "k5_device_ms.serve")
K5 = ("void (anonymous namespace)::bottleneck_tf32x3_kernel<256>(Bottleneck)",
      "void (anonymous namespace)::bottleneck_wgmma_kernel<64>(Bottleneck)")
OTHERS = ("sm80_xmma_fprop_implicit_gemm_f32f32_nchwkcrs_nchw", "bottleneck_kernel<float>",
          "void at::native::elementwise_kernel<128, 2>")


def trace(names, steps):
    """A device trace of kernels of 2 us each, one every 10 us, over `steps`."""
    events = [{"cat": "kernel", "name": n, "ts": 10.0 * i, "dur": 2.0}
              for i, n in enumerate(names)]
    return Trace(events, 1e-3, steps)


@pytest.mark.parametrize("name", READERS)
def test_a_trace_without_k5_reads_nothing(name):
    read = Files(BENCH).module("metrics", name).read
    assert read({"trace": trace(OTHERS * 4, 2)}) is None
    assert read({"trace": trace([], 2)}) is None


def test_k5_is_counted_a_step_by_its_two_kernels():
    files = Files(BENCH)
    t = trace(K5 * 3 + OTHERS * 5, 2)  # 6 K5 launches and 15 others over 2 steps
    assert files.module("metrics", "k5_launches.serve").read({"trace": t}) == 3
    assert files.module("metrics", "k5_launches.train").read({"trace": t}) == 3
    assert files.module("metrics", "k5_device_ms.serve").read({"trace": t}) == \
        pytest.approx(6 * 2e-3 / 2)
