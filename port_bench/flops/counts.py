"""Operations and bytes, counted from shapes: the work of each cell's step
and of each kernel call, whatever implements it.

Conventions:
* a matrix product of [m, k] by [k, n] is 2*m*k*n operations; a
  convolution 2 * output pixels * C_out * C_in * k^2,
* a step that trains a module counts its forward three times (forward,
  and a backward of twice the forward's products); a frozen module
  (the ResNet without autograd) and serving count the forward once,
* elementwise work, normalizations, softmax and lookups are not counted,
* a kernel's bytes are each input read once and each output written
  once, at the dtype the call takes.

Where the port departs from the plain model's work the count follows the
port's call sites, which compute the same function: the CLS-only query
rows of the text->image and text+ROI passes (the only rows their poolers
read), and one ResNet pass over all image slots and all ROI slots, valid
or not.
"""

from __future__ import annotations

PEAK_BF16 = 989e12   # dense bf16 FLOP/s, NVIDIA H100 SXM
PEAK_TF32 = 495e12   # dense TF32 FLOP/s: the fastest the card multiplies f32 operands
HBM_BYTES_S = 3.35e12


def mm(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def layer_fwd(rows_q: int, rows_kv: int, seqs: int, h: int, ffn: int) -> float:
    """One BERT layer over `seqs` sequences: `rows_q` query rows (and FFN
    rows), `rows_kv` key/value rows each."""
    proj = mm(seqs * rows_q, h, h) * 2 + mm(seqs * rows_kv, h, h) * 2  # Q, O; K, V
    attn = 2 * mm(seqs * rows_q, h, rows_kv)  # scores and P @ V over all heads
    return proj + attn + mm(seqs * rows_q, h, ffn) + mm(seqs * rows_q, ffn, h)


def text_encoder_fwd(seqs: int, length: int, t: dict) -> float:
    h = t["hidden_size"]
    per = layer_fwd(length, length, seqs, h, t["intermediate_size"])
    return t["num_hidden_layers"] * per + mm(seqs, h, h)  # + the pooler


def fcmf_fusion_fwd(seqs: int, length: int, cfg: dict) -> float:
    """Everything of the FCMF encoder after the text encoder, for `seqs`
    text sequences (each with I images)."""
    m = cfg["model"]
    h, f = m["hidden_size"], m["intermediate_size"]
    i, r, p, c = cfg["num_imgs"], cfg["num_roi"], cfg["num_patches"], cfg["visual_feat_dim"]
    views = seqs * i
    heads = cfg["box_heads"]
    flop = mm(views * p, c, h) + mm(views * r, c, h)             # vismap2text, roimap2text
    flop += layer_fwd(1, p, views, h, f) + mm(views, h, h)        # text->image, pooler
    flop += 4 * mm(views * r, h, h) + mm(views * r * r, 64, heads) + 2 * mm(views * r, h, r)
    flop += layer_fwd(1, length + r, views, h, f) + mm(views, h, h)  # text+ROI, pooler
    flop += layer_fwd(1 + 2 * i, 1 + 2 * i, seqs, h, f)            # the fusion layer
    return flop


def classifier_fwd(seqs: int, cfg: dict) -> float:
    h = cfg["model"]["hidden_size"]
    return mm(seqs, h, h) + mm(seqs, h, cfg["num_labels"])  # text pooler, classifier


def decoder_fwd(seqs: int, t_dec: int, enc_len: int, dc: dict) -> float:
    """The IAOG decoder with teacher forcing and its tied vocabulary head."""
    h = dc["hidden_size"]
    self_attn = 3 * mm(seqs * t_dec, h, h) + 2 * mm(seqs * t_dec, h, t_dec)  # kx, qx, proj
    cross = mm(seqs * enc_len, h, h) + 2 * mm(seqs * t_dec, h, h) + 2 * mm(seqs * t_dec, h, enc_len)
    ffn = mm(seqs * t_dec, h, dc["ffn_hidden"]) * 2
    return dc["num_blocks"] * (self_attn + cross + ffn) + mm(seqs * t_dec, h, dc["vocab_size"])


def resnet_fwd(frames: int, size: int, stages, nf: int = 64) -> float:
    """ResNet (bottleneck) forward over `frames` square frames."""
    def conv(hw, cin, cout, k):
        return 2.0 * hw * hw * cin * cout * k * k

    s = size // 2
    flop = conv(s, 3, nf, 7)
    s //= 2  # max pool
    cin = nf
    for stage, blocks in enumerate(stages):
        f = nf * 2 ** stage
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            out = s // stride
            flop += conv(s, cin, f, 1) + conv(out, f, f, 3) + conv(out, f, 4 * f, 1)
            if b == 0:
                flop += conv(out, cin, 4 * f, 1)
            s, cin = out, 4 * f
    return frames * flop


def finetune_step(cfg: dict, batch: int, aspects: int, length: int, resnet_frames: int = 0,
                  image_size: int = 224, stages=(3, 8, 36, 3)) -> float:
    """One fine-tune train step: the FCMF trained (x3) over B*A views, and
    the frozen ResNet's forward over `resnet_frames` (0 on cached features)."""
    seqs = batch * aspects
    model = (text_encoder_fwd(seqs, length, cfg["text"]) + fcmf_fusion_fwd(seqs, length, cfg)
             + classifier_fwd(seqs, cfg))
    return 3 * model + resnet_fwd(resnet_frames, image_size, stages)


def serve_batch(cfg: dict, batch: int, aspects: int, length: int, resnet_frames: int,
                image_size: int = 224, stages=(3, 8, 36, 3)) -> float:
    """One served batch: the ResNet over its frames and the FCMF forward."""
    seqs = batch * aspects
    return (resnet_fwd(resnet_frames, image_size, stages)
            + text_encoder_fwd(seqs, length, cfg["text"]) + fcmf_fusion_fwd(seqs, length, cfg)
            + classifier_fwd(seqs, cfg))


def pretrain_step(cfg: dict, dc: dict, batch: int, length: int, t_dec: int) -> float:
    """One Phase-1 step on cached features: encoder and decoder trained (x3)."""
    enc_len = 1 + 2 * cfg["num_imgs"]
    model = (text_encoder_fwd(batch, length, cfg["text"]) + fcmf_fusion_fwd(batch, length, cfg)
             + decoder_fwd(batch, t_dec, enc_len, dc))
    return 3 * model


# ---------------------------------------------------------------------------
# kernels: K1 (attention forward, backward) and K2 (pixels)
# ---------------------------------------------------------------------------

def k1_forward(b: int, l: int, hd: int, heads: int, elt: int, with_lse: bool) -> dict:
    """softmax(QK^T/sqrt(d) + mask) @ V over [B, L, H*d]: q, k, v and the f32
    mask row read; the output (and, under autograd, the f32 row logsumexp)
    written."""
    flop = 4.0 * b * l * l * hd
    nbytes = 4 * b * l * hd * elt + 4 * b * l + (4 * b * heads * l if with_lse else 0)
    return {"flop": flop, "bytes": nbytes}


def k1_backward(b: int, l: int, hd: int, heads: int, elt: int) -> dict:
    """dq, dk, dv from q, k, v, g, the mask row and the logsumexp: the
    scores made again, then dV, dP, dQ, dK (five products)."""
    flop = 10.0 * b * l * l * hd
    nbytes = 7 * b * l * hd * elt + 4 * b * l + 4 * b * heads * l
    return {"flop": flop, "bytes": nbytes}


def k2_unpack(frames: int, valid: int, size: int, out_elt: int) -> dict:
    """Packed frames -> normalized frames: each frame's validity word read,
    a valid frame's bytes read, every frame's output written (zeros for an
    empty slot)."""
    px = size * size * 3
    return {"flop": 3.0 * valid * px,
            "bytes": 4 * frames + valid * px + frames * px * out_elt}


def bound_s(work: dict, peak_flops: float) -> float:
    """The least time the card could take: operations at `peak_flops` or
    bytes at the HBM rate, whichever is longer."""
    return max(work["flop"] / peak_flops, work["bytes"] / HBM_BYTES_S)
