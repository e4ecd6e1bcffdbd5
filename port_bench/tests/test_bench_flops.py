"""The benchmark's operation and byte counts against hand counts at small
shapes."""

import pytest

from port_bench.flops import counts


def test_matmul_and_layer():
    assert counts.mm(2, 3, 4) == 48
    # 2 sequences of 3 rows, width 4, FFN 8: Q,K,V,O 4 x 2*6*4*4, scores and
    # P@V 2 x 2*6*4*3, FFN 2 x 2*6*4*8
    assert counts.layer_fwd(3, 3, 2, 4, 8) == 4 * 192 + 2 * 144 + 2 * 384


def test_resnet_one_block_a_stage():
    # 32 x 32 input, nf 1, one bottleneck a stage
    def conv(hw, cin, cout, k):
        return 2 * hw * hw * cin * cout * k * k

    want = conv(16, 3, 1, 7)
    s, cin = 8, 1
    for stage in range(4):
        f = 2 ** stage
        out = s // (2 if stage else 1)
        want += conv(s, cin, f, 1) + conv(out, f, f, 3) + conv(out, f, 4 * f, 1)
        want += conv(out, cin, 4 * f, 1)
        s, cin = out, 4 * f
    assert counts.resnet_fwd(3, 32, (1, 1, 1, 1), nf=1) == 3 * want


def test_resnet152_forward_is_torchvisions():
    # torchvision lists ResNet-152 at 11.51 G multiply-adds a 224 frame
    assert counts.resnet_fwd(1, 224, (3, 8, 36, 3)) / 2 == pytest.approx(11.51e9, rel=0.01)


def test_k1_counts_at_the_text_encoders_shape():
    f = counts.k1_forward(48, 170, 768, 12, 2, False)
    assert f["flop"] == pytest.approx(4.261e9, rel=1e-3)
    assert f["bytes"] == 4 * 48 * 170 * 768 * 2 + 4 * 48 * 170
    b = counts.k1_backward(2, 3, 8, 2, 4)
    assert b["flop"] == 10 * 2 * 9 * 8
    assert b["bytes"] == 7 * 2 * 3 * 8 * 4 + 4 * 2 * 3 + 4 * 2 * 2 * 3


def test_k2_counts_an_empty_frame_by_its_validity_word():
    got = counts.k2_unpack(frames=3, valid=2, size=2, out_elt=2)
    assert got["bytes"] == 3 * 4 + 2 * 12 + 3 * 12 * 2
    assert counts.bound_s({"flop": 0.0, "bytes": 3.35e12}, 1.0e15) == pytest.approx(1.0)


def test_step_counts_add_their_parts():
    cfg = {"text": {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2},
           "model": {"hidden_size": 4, "intermediate_size": 8}, "num_imgs": 1, "num_roi": 1,
           "num_patches": 2, "visual_feat_dim": 3, "box_heads": 2, "num_labels": 4}
    model = (counts.text_encoder_fwd(6, 5, cfg["text"]) + counts.fcmf_fusion_fwd(6, 5, cfg)
             + counts.classifier_fwd(6, cfg))
    assert counts.finetune_step(cfg, 1, 6, 5) == 3 * model
    assert counts.serve_batch(cfg, 1, 6, 5, 0) == model
