"""FCMF Seq2Seq — the Phase-1 IAOG pretraining model, in PyTorch.

Counterpart of `macsa_tpu/models/seq2seq.py` (reference:
fcmf_framework/fcmf_pretraining.py:143-221): FCMFEncoder + IAOGDecoder with
three-way weight tying (decoder embedding = backbone word embeddings =
output head, fcmf_pretraining.py:162-166).  The token table is ONE
`nn.Parameter`: `decoder.embedding.weight`, `decoder.dense.weight` and
`encoder.bert.cell.embeddings.word_embeddings.weight` are that object, so
autograd sums the three uses into one gradient and an optimizer built from
`named_parameters()` sees the table once.  `state_dict()` lists it under
all three names, the reference checkpoint's; `load_state_dict` takes a
state dict that names it once, twice or three times with equal values.

The decoder cross-attention mask is rebuilt exactly as the reference does
(fcmf_pretraining.py:184-195): combined = [text_mask[:, :fused_len - 2*I],
ones(2*I)] over the fused encoder sequence (fused_len = 1+2*I, so the text
slice is the single CLS slot).

Decode: greedy and batched beam search as Python loops of `max_len` steps
over the decoder's preallocated KV cache; nothing inside a loop reads a
value back from the device (`done` stays a tensor).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from macsa_tpu_torch.config import DecoderConfig, FCMFConfig
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.models.decoder import IAOGDecoder
from macsa_tpu_torch.models.fcmf import FCMFEncoder

TIED_TABLE_NAMES = ("decoder.embedding.weight", "decoder.dense.weight",
                    "encoder.bert.cell.embeddings.word_embeddings.weight")
NEG_INF = -1e9  # a dead beam's score


class FCMFSeq2Seq(nn.Module):
    def __init__(self, config: FCMFConfig, decoder_config: DecoderConfig, device=None):
        super().__init__()
        self.config = config
        self.decoder_config = decoder_config
        table = nn.Parameter(torch.empty(decoder_config.vocab_size, config.model.hidden_size,
                                         device=device))
        self.encoder = FCMFEncoder(config, device=device, embedding_table=table)
        self.decoder = IAOGDecoder(decoder_config, config.decoder_cross_mask_mode,
                                   embedding_table=table, device=device)

    @property
    def shared_embedding(self) -> nn.Parameter:
        """The token table, tied three ways."""
        return self.decoder.embedding.weight

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """As `nn.Module.load_state_dict`, but the tied table may stand under
        any of its three names: the names that are missing take the value of
        the ones given, and names given with unequal values are refused."""
        given = [k for k in TIED_TABLE_NAMES if k in state_dict]
        if given:
            state_dict = dict(state_dict)
            first = state_dict[given[0]]
            for name in given[1:]:
                if not torch.equal(torch.as_tensor(state_dict[name]), torch.as_tensor(first)):
                    raise ValueError(f"{name} and {given[0]} are one tied table in this model, "
                                     "but the state dict holds different values for them")
            for name in TIED_TABLE_NAMES:
                state_dict.setdefault(name, first)
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def encode(self, enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
               token_type_ids=None, attention_mask=None, added_attention_mask=None,
               rng: Optional[layers.DropoutRng] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (fused encoder sequence [B, 1+2I, H], combined mask [B, 1+2I])."""
        enc_output = self.encoder(enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
                                  token_type_ids, attention_mask, added_attention_mask, rng)
        # the decoder cross mask (fcmf_pretraining.py:184-195)
        num_visual = 2 * self.config.num_imgs
        text_len = enc_output.shape[1] - num_visual  # == 1 (the fused CLS slot)
        if attention_mask is None:
            attention_mask = torch.ones_like(enc_input_ids)
        text_mask = attention_mask[:, :text_len]
        vis_mask = torch.ones(enc_output.shape[0], num_visual, dtype=text_mask.dtype,
                              device=text_mask.device)
        return enc_output, torch.cat([text_mask, vis_mask], dim=1)

    def forward(self, enc_input_ids, dec_input_ids, visual_embeds_att, roi_embeds_att,
                roi_coors, token_type_ids=None, attention_mask=None,
                added_attention_mask=None, rng: Optional[layers.DropoutRng] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """Teacher-forcing forward -> [B, T_dec, V] f32 logits (or the
        decoder's hidden states [B, T_dec, H] with `return_hidden`, for
        `chunked_seq2seq_loss`)."""
        enc_output, combined_mask = self.encode(
            enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors, token_type_ids,
            attention_mask, added_attention_mask, rng)
        return self.decoder(dec_input_ids, enc_output, combined_mask, rng,
                            return_hidden=return_hidden)

    # ------------------------------------------------------------------
    # Decoding (deterministic: no rng reaches a module, so no dropout)
    # ------------------------------------------------------------------

    def decode_step(self, token: torch.Tensor, enc_output: torch.Tensor,
                    combined_mask: torch.Tensor, cache, step: int) -> torch.Tensor:
        """One incremental decoder step. token [B, 1] -> logits [B, 1, V];
        `cache` is updated in place."""
        return self.decoder(token, enc_output, combined_mask, cache=cache, step=step)

    @torch.inference_mode()
    def greedy_decode(self, enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
                      bos_id: int, eos_id: int, token_type_ids=None, attention_mask=None,
                      added_attention_mask=None, max_len: Optional[int] = None
                      ) -> torch.Tensor:
        """Batched greedy decode -> [B, max_len] token ids (eos-padded)."""
        max_len = max_len or self.decoder_config.max_decode_len
        enc_output, combined_mask = self.encode(
            enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors, token_type_ids,
            attention_mask, added_attention_mask)
        b, dev = enc_input_ids.shape[0], enc_input_ids.device
        cache = self.decoder.init_cache(b, dev)
        token = torch.full((b, 1), bos_id, dtype=torch.long, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        tokens = []
        for step in range(max_len):
            logits = self.decode_step(token, enc_output, combined_mask, cache, step)
            nxt = torch.where(done, eos_id, logits[:, -1, :].argmax(dim=-1))
            done = done | (nxt == eos_id)
            token = nxt[:, None]
            tokens.append(nxt)
        return torch.stack(tokens, dim=1).to(torch.int32)

    @torch.inference_mode()
    def beam_decode(self, enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
                    bos_id: int, eos_id: int, beam_size: int = 3, token_type_ids=None,
                    attention_mask=None, added_attention_mask=None,
                    max_len: Optional[int] = None, length_penalty: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched beam search -> (best sequences [B, max_len], scores [B]).

        The reference's per-sample beams with KV-cache cloning
        (fcmf_pretraining.py:437-507) with the beams folded into the batch
        axis and the caches gather-reordered each step, as the JAX package
        does it: beam 0 starts live at score 0 and the others dead at -1e9,
        so the first step seeds k distinct continuations of BOS; a finished
        beam only extends with eos, at no cost.  The decoder runs at batch
        B*k (which `emulate_reference_heads` pairs heads by)."""
        max_len = max_len or self.decoder_config.max_decode_len
        k, v = beam_size, self.decoder_config.vocab_size
        enc_output, combined_mask = self.encode(
            enc_input_ids, visual_embeds_att, roi_embeds_att, roi_coors, token_type_ids,
            attention_mask, added_attention_mask)
        b, dev = enc_input_ids.shape[0], enc_input_ids.device
        enc_output_e = enc_output.repeat_interleave(k, dim=0)  # [B*k, ...]
        combined_mask_e = combined_mask.repeat_interleave(k, dim=0)
        cache = self.decoder.init_cache(b * k, dev)

        scores = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b, 1)  # [B, k]
        tokens = torch.full((b, k, 1), bos_id, dtype=torch.long, device=dev)
        seqs = torch.full((b, k, max_len), eos_id, dtype=torch.long, device=dev)
        done = torch.zeros(b, k, dtype=torch.bool, device=dev)
        eos_only = torch.full((v,), NEG_INF, device=dev)
        eos_only[eos_id] = 0.0
        batch_base = torch.arange(b, device=dev)[:, None] * k

        for step in range(max_len):
            logits = self.decode_step(tokens.reshape(b * k, 1), enc_output_e, combined_mask_e,
                                      cache, step)
            logp = torch.log_softmax(logits[:, -1, :], dim=-1).reshape(b, k, v)
            logp = torch.where(done[..., None], eos_only, logp)
            cand = scores[..., None] + logp  # [B, k, V]
            scores, idx = torch.topk(cand.reshape(b, k * v), k, dim=1)  # [B, k]
            beam_idx = idx // v
            tok_idx = idx % v
            seqs = torch.gather(seqs, 1, beam_idx[..., None].expand(-1, -1, max_len))
            seqs[:, :, step] = tok_idx
            done = torch.gather(done, 1, beam_idx) | (tok_idx == eos_id)
            # reorder the caches: flat row = b*k + beam
            flat_idx = (batch_base + beam_idx).reshape(-1)
            cache = {name: kv[flat_idx] for name, kv in cache.items()}
            tokens = tok_idx[..., None]

        if length_penalty > 0.0:
            lengths = (seqs != eos_id).sum(dim=-1) + 1.0
            scores = scores / lengths ** length_penalty
        best = scores.argmax(dim=1)
        rows = torch.arange(b, device=dev)
        return seqs[rows, best].to(torch.int32), scores[rows, best]


def seq2seq_loss(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = -100) -> torch.Tensor:
    """Token-level CE with ignore mask — CrossEntropyLoss(ignore_index=-100)
    over decoder logits (run_pretraining_fcmf.py:322-324), in f32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


class _ChunkedHeadLoss(torch.autograd.Function):
    """Mean CE over the valid tokens of the tied vocabulary head, its
    logits made one vocabulary chunk at a time in the forward (online
    logsumexp) and made again chunk by chunk in the backward: no [N, V]
    tensor is ever held."""

    @staticmethod
    def forward(ctx, x, emb, bias, safe, valid, chunk_size):
        n, v = x.shape[0], emb.shape[0]
        m = torch.full((n,), -torch.inf, device=x.device)
        s = torch.zeros(n, device=x.device)
        best_val = torch.full((n,), -torch.inf, device=x.device)
        best_idx = torch.zeros(n, dtype=torch.long, device=x.device)
        for c0 in range(0, v, chunk_size):
            logits_c = x @ emb[c0:c0 + chunk_size].T + bias[c0:c0 + chunk_size]  # [N, C]
            c_max, c_arg = logits_c.max(dim=1)  # the first index on ties
            m_new = torch.maximum(m, c_max)
            s = s * torch.exp(m - m_new) + torch.exp(logits_c - m_new[:, None]).sum(1)
            m = m_new
            better = c_max > best_val  # strict: an earlier chunk keeps a tie
            best_val = torch.where(better, c_max, best_val)
            best_idx = torch.where(better, c_arg + c0, best_idx)
        lse = m + torch.log(s)
        # label logit via row gather: an [N, H] product, not [N, V]
        label_logit = (x * emb[safe]).sum(1) + bias[safe]
        count = valid.sum().clamp(min=1)
        nll = torch.where(valid, lse - label_logit, 0.0)
        ctx.save_for_backward(x, emb, bias, safe, valid, lse, count)
        ctx.chunk_size = chunk_size
        ctx.mark_non_differentiable(best_idx)
        return nll.sum() / count, best_idx

    @staticmethod
    def backward(ctx, grad_loss, _grad_idx):
        x, emb, bias, safe, valid, lse, count = ctx.saved_tensors
        chunk_size, v = ctx.chunk_size, emb.shape[0]
        coef = valid.to(x.dtype) / count * grad_loss  # d loss / d nll_n
        grad_x = torch.zeros_like(x)
        grad_emb, grad_bias = torch.empty_like(emb), torch.empty_like(bias)
        for c0 in range(0, v, chunk_size):
            e_c = emb[c0:c0 + chunk_size]
            logits_c = x @ e_c.T + bias[c0:c0 + chunk_size]
            # d nll / d logit = softmax - onehot(label)
            g = torch.exp(logits_c - lse[:, None]) * coef[:, None]
            here = (safe >= c0) & (safe < c0 + e_c.shape[0])
            col = (safe - c0).clamp(0, e_c.shape[0] - 1)
            g.scatter_add_(1, col[:, None], (-coef * here)[:, None])
            grad_x += g @ e_c
            grad_emb[c0:c0 + chunk_size] = g.T @ x
            grad_bias[c0:c0 + chunk_size] = g.sum(0)
        return grad_x, grad_emb, grad_bias, None, None, None


def chunked_seq2seq_loss(hidden: torch.Tensor, embedding_table: torch.Tensor,
                         out_bias: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -100, chunk_size: int = 8192
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE + argmax over the weight-tied vocabulary head WITHOUT holding the
    [B, T, V] f32 logits, for the forward or for the backward.

    An online logsumexp (m, s) and a running argmax go over the vocabulary
    in chunks of `chunk_size` rows; the backward makes each chunk's [N, C]
    logits again instead of keeping them.  Gradient-exact:
    d lse / d logit_i = exp(logit_i - lse) whatever the max-shift was, and
    the label's logit differentiates through a row gather.

    -> (mean-over-valid-token CE, argmax token ids [B, T])."""
    b, t, h = hidden.shape
    valid = (labels != ignore_index).reshape(-1)
    safe = torch.where(valid, labels.reshape(-1), 0).long()
    loss, best_idx = _ChunkedHeadLoss.apply(
        hidden.float().reshape(b * t, h), embedding_table.float(), out_bias.float(),
        safe, valid, chunk_size)
    return loss, best_idx.reshape(b, t)
