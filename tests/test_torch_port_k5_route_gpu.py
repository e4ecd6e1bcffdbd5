"""The frozen ResNet's route through K5 on the card (`models/resnet.takes_k5`).

Every test here needs a CUDA device and the CUDA toolkit (`nvcc`), and
skips without them.  The file imports no JAX, so on the card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_port_k5_route_gpu.py -m gpu --noconftest -q

At ResNet widths (64 filters) and 224^2 the heads' identity blocks of
stages 1-3 run K5 (f32 "tf32x3", bf16 "wgmma") and stage 4 runs its
modules; the module path (`fused_backbone.extract_features(..., stages=())`)
is the yardstick: f32 within 1e-4 of max|ref|, bf16 no further from the
f32 module path than twice the bf16 module path.
"""

import pytest
import torch

from macsa_tpu_torch.models import fused_backbone, resnet
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.train.steps import visual_features
from test_torch_port_k5_route import K5_OP, export_serving, small_program, wide_visual

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _frames(cuda, size=224):
    """32 images and 64 ROI crops: over `K5_MIN_FRAMES`."""
    g = torch.Generator(cuda).manual_seed(20)
    return (torch.randn(2, 16, size, size, 3, device=cuda, generator=g),
            torch.randn(2, 16, 2, size, size, 3, device=cuda, generator=g))


def _heads(visual, images, rois):
    return visual.grid_features(images), visual.pooled_features(rois)


def test_the_heads_take_k5_in_the_blocks_the_rule_names(cuda):
    """f32 and bf16 heads without autograd: one K5 launch per identity block
    of stages 1-3 a pass (two passes), of the dtype's tensor-core variant,
    none over a single frame; f32 within 1e-4 of the module path, bf16 no
    further from it than twice the bf16 module path."""
    visuals = {"float32": wide_visual(21, "float32", cuda, grid_size=7),
               "bfloat16": wide_visual(21, "bfloat16", cuda, grid_size=7)}
    images, rois = _frames(cuda)
    feats = {}
    with torch.no_grad():
        for dtype, visual in visuals.items():
            per_pass = resnet.k5_blocks(visual.config, 224, 32)
            assert per_pass == 3
            cuda_lib.reset_launch_counts()
            feats[dtype] = _heads(visual, images, rois)
            torch.cuda.synchronize()
            variant = "tf32x3" if dtype == "float32" else "wgmma"
            assert dict(cuda_lib.launch_counts) == {"fused_bottleneck": 2 * per_pass,
                                                    f"fused_bottleneck.{variant}": 2 * per_pass}
            cuda_lib.reset_launch_counts()
            feats["module_" + dtype] = fused_backbone.extract_features(visual, images, rois,
                                                                       stages=())
            visual.pooled_features(images[:1, :1])  # a tagger's one image
            assert not cuda_lib.launch_counts
    for i in range(2):  # grid, roi
        want = feats["module_float32"][i]
        assert feats["float32"][i].shape == want.shape
        assert _rel_err(feats["float32"][i], want) <= 1e-4
        assert _rel_err(feats["bfloat16"][i], want) <= \
            2 * _rel_err(feats["module_bfloat16"][i], want)


def test_a_stage_enters_and_leaves_k5_without_a_copy(cuda, monkeypatch):
    """The rows K5 takes at a stage's entry are the bytes of block 0's
    channels-last output, and the next stage's block 0 reads the bytes of
    the last K5 block's rows (one identity block a stage here)."""
    visual = wide_visual(22, "float32", cuda, grid_size=7)
    block0_in, block0_out, k5_rows = {}, {}, []
    for stage in (1, 2, 3, 4):
        block0 = getattr(visual, f"layer{stage}")[0]
        block0.register_forward_pre_hook(
            lambda m, args, s=stage: block0_in.__setitem__(s, args[0].data_ptr()))
        block0.register_forward_hook(
            lambda m, args, out, s=stage: block0_out.__setitem__(s, out.data_ptr()))
    k5 = resnet.fused_bottleneck

    def recorded(x2, *args):
        out = k5(x2, *args)
        k5_rows.append((x2.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(resnet, "fused_bottleneck", recorded)
    with torch.no_grad():
        visual.grid_features(_frames(cuda)[0])
    assert [entry for entry, _ in k5_rows] == [block0_out[s] for s in (1, 2, 3)]
    assert [exit_ for _, exit_ in k5_rows] == [block0_in[s] for s in (2, 3, 4)]


def test_autograd_on_the_cnn_launches_no_k5(cuda):
    """`--fine_tune_cnn`: the visual layer under autograd runs the modules."""
    model, visual, batch = small_program(cuda)
    visual.train()
    cuda_lib.reset_launch_counts()
    grid, roi = visual_features(model, visual, batch, fine_tune_cnn=True)
    (grid.float().square().sum() + roi.float().square().sum()).backward()
    torch.cuda.synchronize()
    assert "fused_bottleneck" not in cuda_lib.launch_counts
    assert visual.layer1[1].conv2.weight.grad is not None
    with torch.no_grad():
        cuda_lib.reset_launch_counts()
        visual_features(model, visual, batch)  # the frozen CNN: one block a pass
        assert cuda_lib.launch_counts["fused_bottleneck.tf32x3"] == 2


def test_the_exported_program_holds_k5_and_equals_the_live_step(cuda):
    """A small serving forward exported on the card holds K5's registered
    op (one identity block a pass at 64^2) and gives the live step's logits."""
    exported, inputs, live = export_serving(*small_program(cuda))
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count(K5_OP) == 2
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        got = exported.module()(*inputs)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_bottleneck.tf32x3"] == 2
    torch.testing.assert_close(got, live, rtol=0, atol=1e-5)
