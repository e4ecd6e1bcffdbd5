"""Generation evaluation for Phase 1: batched decode + ROUGE + BERTScore.

Counterpart of `macsa_tpu/train/generation.py`.  The reference's eval
harness is commented out but definitive for capabilities (reference:
run_pretraining_fcmf.py:376-452): per-sample beam search, then BERTScore
(visobert, num_layers=12) macro-averaged per aspect, plus ROUGE.  Here
decoding is batched (beams folded into the batch,
`macsa_tpu_torch.models.seq2seq`), ROUGE-1/-L are computed in Python
(`rouge_scores`, a copy of the JAX package's), and BERTScore runs as an
eval-only forward of the model's own text backbone (greedy cosine matching
over final-layer states, idf-less F1 — the bert-score default recipe).
The backbone is always there, so BERTScore is always reported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from macsa_tpu_torch.data.loader import DataLoader, pad_batch
from macsa_tpu_torch.train.common import to_device
from macsa_tpu_torch.train.steps import visual_features


def _lcs_len(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_scores(pred: str, ref: str) -> Dict[str, float]:
    p, r = pred.split(), ref.split()
    if not p or not r:
        return {"rouge1": 0.0, "rougeL": 0.0}
    overlap = 0
    ref_counts: Dict[str, int] = {}
    for t in r:
        ref_counts[t] = ref_counts.get(t, 0) + 1
    for t in p:
        if ref_counts.get(t, 0) > 0:
            overlap += 1
            ref_counts[t] -= 1
    prec, rec = overlap / len(p), overlap / len(r)
    r1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    lcs = _lcs_len(p, r)
    lp, lr = lcs / len(p), lcs / len(r)
    rl = 2 * lp * lr / (lp + lr) if lp + lr else 0.0
    return {"rouge1": r1, "rougeL": rl}


@torch.inference_mode()
def bert_score_f1(cands: List[str], refs: List[str], text_encoder, tokenizer,
                  max_len: int = 64, batch_size: int = 16) -> float:
    """Greedy-cosine BERTScore F1 with a port `TextEncoder` (final layer),
    run deterministically on the device its parameters are on."""
    device = next(text_encoder.parameters()).device
    was_training = text_encoder.training
    text_encoder.eval()

    def encode(texts):
        outs, masks = [], []
        for i in range(0, len(texts), batch_size):
            tok = tokenizer(list(texts[i:i + batch_size]), max_length=max_len,
                            padding="max_length", truncation=True)
            ids = torch.tensor(tok["input_ids"], dtype=torch.int32, device=device)
            mask = torch.tensor(tok["attention_mask"], dtype=torch.int32, device=device)
            seq, _ = text_encoder(ids, None, mask)
            outs.append(seq.float().cpu().numpy())
            masks.append(mask.cpu().numpy())
        return np.concatenate(outs), np.concatenate(masks)

    try:
        c_emb, c_mask = encode(cands)
        r_emb, r_mask = encode(refs)
    finally:
        text_encoder.train(was_training)
    f1s = []
    for ce, cm, re_, rm in zip(c_emb, c_mask, r_emb, r_mask):
        ce = ce[cm.astype(bool)]
        re_ = re_[rm.astype(bool)]
        ce = ce / np.maximum(np.linalg.norm(ce, axis=-1, keepdims=True), 1e-9)
        re_ = re_ / np.maximum(np.linalg.norm(re_, axis=-1, keepdims=True), 1e-9)
        sim = ce @ re_.T
        p = sim.max(axis=1).mean()
        r = sim.max(axis=0).mean()
        f1s.append(2 * p * r / (p + r) if p + r else 0.0)
    return float(np.mean(f1s))


def special_token_ids(tokenizer):
    """(bos, eos) as the drivers pick them (run_pretraining_fcmf.py:340-372)."""
    bos = tokenizer.bos_token_id or tokenizer.cls_token_id or 0
    eos = tokenizer.eos_token_id or tokenizer.sep_token_id or 2
    return bos, eos


def decode_text(tokenizer, ids, drop_id: int) -> str:
    return tokenizer.decode([int(t) for t in ids if t != drop_id], skip_special_tokens=True)


def evaluate_generation(model, visual, dataset, tokenizer, batch_size: int,
                        device, beam_size: int = 3, max_len: int = 20,
                        max_samples: Optional[int] = 200, logger=None) -> Dict[str, float]:
    """Batched greedy (beam_size <= 1) or beam decode over the dev set,
    scored with ROUGE and BERTScore, macro-averaged per aspect
    (run_pretraining_fcmf.py:428-440 capability)."""
    bos_id, eos_id = special_token_ids(tokenizer)
    loader = DataLoader(dataset, batch_size, num_workers=8)
    per_aspect: Dict[str, List[Dict[str, float]]] = {}
    cands_all, refs_all, aspects_all = [], [], []
    seen = 0
    for batch in loader:
        if max_samples is not None and seen >= max_samples:
            break
        aspects = batch.pop("target_aspect")
        dec_ids = batch.pop("dec_input_ids")
        for key in ("text", "_idx", "orig_idx", "labels"):
            batch.pop(key, None)
        b = dec_ids.shape[0]
        sent = to_device(pad_batch(batch, batch_size), device)
        with torch.inference_mode():
            grid, roi = visual_features(model, visual, sent)
        args = (sent["enc_input_ids"], grid, roi, sent["roi_coors"], bos_id, eos_id)
        kw = dict(attention_mask=sent["attention_mask"],
                  added_attention_mask=sent["added_mask"], max_len=max_len)
        if beam_size <= 1:
            seqs = model.greedy_decode(*args, **kw)
        else:
            seqs, _ = model.beam_decode(*args, beam_size=beam_size, **kw)
        seqs = seqs.cpu().numpy()[:b]
        for k in range(b):
            pred = decode_text(tokenizer, seqs[k], eos_id)
            ref = decode_text(tokenizer, dec_ids[k], tokenizer.pad_token_id)
            cands_all.append(pred)
            refs_all.append(ref)
            aspects_all.append(aspects[k])
            per_aspect.setdefault(aspects[k], []).append(rouge_scores(pred, ref))
        seen += b

    out: Dict[str, float] = {}
    for key in ("rouge1", "rougeL"):
        per_asp_means = [float(np.mean([s[key] for s in scores]))
                         for scores in per_aspect.values()]
        out[key] = float(np.mean(per_asp_means)) if per_asp_means else 0.0

    # BERTScore with the model's own text backbone (its word embeddings are
    # the tied token table)
    if per_aspect:
        backbone = model.encoder.bert.cell
        scores = {}
        for asp in per_aspect:
            idx = [i for i, a in enumerate(aspects_all) if a == asp]
            scores[asp] = bert_score_f1([cands_all[i] for i in idx],
                                        [refs_all[i] for i in idx], backbone, tokenizer)
        out["bertscore_f1"] = float(np.mean(list(scores.values())))
    if logger:
        logger.info(f"generation eval over {seen} samples, {len(per_aspect)} aspects")
    return out
