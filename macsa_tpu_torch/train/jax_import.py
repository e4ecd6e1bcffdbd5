"""Carry the JAX package's parameters into the port's modules.

The port's modules use the reference checkpoint's names, so the JAX
package's own importers (`macsa_tpu.train.torch_import.
import_fcmf_classifier`, `macsa_tpu.models.resnet.import_torchvision_resnet`)
read a port `state_dict()` directly.  This module is their inverse: JAX
parameter trees, given as numpy (or numpy-convertible) arrays, become
state dicts of torch tensors for `load_state_dict(strict=True)`.

Dense kernels are flax [in, out] and torch [out, in]; conv kernels are flax
[kh, kw, in, out] and torch [out, in, kh, kw]; LayerNorm `scale` is torch
`weight`.  Only the unrolled text-encoder layout (`layer_{i}`) is read.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def dense_state_dict(p) -> StateDict:
    out = {"weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out["bias"] = _t(p["bias"])
    return out


def layer_norm_state_dict(p) -> StateDict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def bert_block_state_dict(p) -> StateDict:
    """One BertLayer / BertCrossAttentionLayer (flax `attention` + `mlp`)."""
    att, mlp = p["attention"], p["mlp"]
    sd: StateDict = {}
    for name in ("query", "key", "value"):
        sd.update(_prefixed(f"attention.self.{name}", dense_state_dict(att["self"][name])))
    sd.update(_prefixed("attention.output.dense", dense_state_dict(att["output"]["dense"])))
    sd.update(_prefixed("attention.output.LayerNorm",
                        layer_norm_state_dict(att["output"]["LayerNorm"])))
    sd.update(_prefixed("intermediate.dense", dense_state_dict(mlp["intermediate_dense"])))
    sd.update(_prefixed("output.dense", dense_state_dict(mlp["output_dense"])))
    sd.update(_prefixed("output.LayerNorm", layer_norm_state_dict(mlp["output_LayerNorm"])))
    return sd


def text_encoder_state_dict_from_jax(p, num_layers: int) -> StateDict:
    """TextEncoder params -> HF RoBERTa keys (inverse of
    `macsa_tpu.models.text_encoder.import_hf_text_encoder`)."""
    if "layers" in p:
        raise ValueError("scanned (stacked) text-encoder params: unstack them first")
    emb = p["embeddings"]
    sd: StateDict = {f"embeddings.{name}.weight": _t(emb[name]["embedding"])
                     for name in ("word_embeddings", "position_embeddings",
                                  "token_type_embeddings")}
    sd.update(_prefixed("embeddings.LayerNorm", layer_norm_state_dict(emb["LayerNorm"])))
    for i in range(num_layers):
        sd.update(_prefixed(f"encoder.layer.{i}", bert_block_state_dict(p[f"layer_{i}"])))
    sd.update(_prefixed("pooler.dense", dense_state_dict(p["pooler"]["dense"])))
    return sd


def box_head_state_dict(p) -> StateDict:
    """BoxMultiHeadedAttention params -> `linears.{0..3}`, `WGs.{h}`."""
    sd: StateDict = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj", "out_proj")):
        sd.update(_prefixed(f"linears.{i}", dense_state_dict(p[name])))
    kernel = np.asarray(p["wg"]["kernel"])  # [64, heads]
    bias = np.asarray(p["wg"]["bias"])
    for h in range(kernel.shape[1]):
        sd[f"WGs.{h}.weight"] = _t(kernel[:, h][None, :])
        sd[f"WGs.{h}.bias"] = _t(bias[h:h + 1])
    return sd


def fcmf_encoder_state_dict_from_jax(enc, num_text_layers: int) -> StateDict:
    """FCMFEncoder params -> `encoder.*` keys (inverse of
    `macsa_tpu.train.torch_import.import_fcmf_encoder`)."""
    sd = _prefixed("encoder.bert.cell",
                   text_encoder_state_dict_from_jax(enc["bert"], num_text_layers))
    for name in ("vismap2text", "roimap2text"):
        sd.update(_prefixed(f"encoder.{name}", dense_state_dict(enc[name])))
    for name in ("text2img_pooler", "text2roi_pooler"):
        sd.update(_prefixed(f"encoder.{name}.dense", dense_state_dict(enc[name]["dense"])))
    sd.update(_prefixed("encoder.box_head", box_head_state_dict(enc["box_head"])))
    for name in ("text2img_attention", "mm_attention"):
        sd.update(_prefixed(f"encoder.{name}.layer.0",
                            bert_block_state_dict(enc[name]["layer_0"])))
    return sd


def fcmf_state_dict_from_jax(params, num_text_layers: int) -> StateDict:
    """FCMF classifier params -> reference-named state dict (inverse of
    `macsa_tpu.train.torch_import.import_fcmf_classifier`)."""
    sd = fcmf_encoder_state_dict_from_jax(params["encoder"], num_text_layers)
    sd.update(_prefixed("text_pooler.dense", dense_state_dict(params["text_pooler"]["dense"])))
    sd.update(_prefixed("classifier", dense_state_dict(params["classifier"])))
    return sd


def decoder_block_state_dict(p) -> StateDict:
    """One TransformerDecoderBlock: per-head `w_kx`/`w_qx` as they are,
    `proj` and the FFN transposed, the AddNorms' `ln`."""
    sd: StateDict = {}
    for name in ("attention1", "attention2"):
        sd[f"{name}.w_kx"], sd[f"{name}.w_qx"] = _t(p[name]["w_kx"]), _t(p[name]["w_qx"])
        if "weight" in p[name]:  # the mlp / bi_linear score functions
            sd[f"{name}.weight"] = _t(p[name]["weight"])
        sd.update(_prefixed(f"{name}.proj", dense_state_dict(p[name]["proj"])))
    for name in ("addnorm1", "addnorm2", "add_norm3"):
        sd.update(_prefixed(f"{name}.ln", layer_norm_state_dict(p[name]["ln"])))
    for name in ("dense1", "dense2"):
        sd.update(_prefixed(f"ffn.{name}", dense_state_dict(p["ffn"][name])))
    return sd


def seq2seq_state_dict_from_jax(params, num_text_layers: int, num_blocks: int) -> StateDict:
    """FCMFSeq2Seq params -> reference-named state dict (inverse of
    `macsa_tpu.train.torch_import.import_fcmf_seq2seq`).  The tied token
    table `shared_embedding` goes under all three of its names."""
    dec = params["decoder"]
    if "blocks" in dec:
        raise ValueError("scanned (stacked) decoder params: unstack them first "
                         "(macsa_tpu.models.decoder.unstack_block_params)")
    bert = dict(params["encoder"]["bert"])
    bert["embeddings"] = {**bert["embeddings"],
                          "word_embeddings": {"embedding": params["shared_embedding"]}}
    sd = fcmf_encoder_state_dict_from_jax({**params["encoder"], "bert": bert},
                                          num_text_layers)
    table = sd["encoder.bert.cell.embeddings.word_embeddings.weight"]
    sd["decoder.embedding.weight"] = sd["decoder.dense.weight"] = table
    sd["decoder.dense.bias"] = _t(dec["out_bias"])
    for i in range(num_blocks):
        sd.update(_prefixed(f"decoder.blks.block{i}", decoder_block_state_dict(dec[f"block_{i}"])))
    return sd


def _param_paths(to_state_dict, params) -> Dict[str, Tuple[str, ...]]:
    """State-dict name -> path of the JAX leaf it is made from, read off
    `to_state_dict` run on a tree whose leaves hold their own index, so the
    map cannot drift from the importer."""
    paths: list = []

    def mark(tree, prefix):
        if isinstance(tree, Mapping):
            return {k: mark(v, prefix + (k,)) for k, v in tree.items()}
        paths.append(prefix)
        return np.full(np.shape(tree), len(paths) - 1, np.float32)

    sd = to_state_dict(mark(params, ()))
    return {name: paths[int(t.reshape(-1)[0])] for name, t in sd.items()}


def fcmf_param_paths(params, num_text_layers: int) -> Dict[str, Tuple[str, ...]]:
    """Port parameter name -> path of the JAX FCMF leaf it is made from
    (the box head's per-head gates `WGs.{h}.*` share the `wg` leaves)."""
    return _param_paths(lambda p: fcmf_state_dict_from_jax(p, num_text_layers), params)


def seq2seq_param_paths(params, num_text_layers: int,
                        num_blocks: int) -> Dict[str, Tuple[str, ...]]:
    """As `fcmf_param_paths`, for FCMFSeq2Seq: the table's three names all
    map to `("shared_embedding",)`."""
    return _param_paths(
        lambda p: seq2seq_state_dict_from_jax(p, num_text_layers, num_blocks), params)


def visual_state_dict_from_jax(visual_params) -> StateDict:
    """VisualFeatures params `{"backbone": ...}` -> torchvision keys (inverse
    of `macsa_tpu.models.resnet.import_torchvision_resnet`)."""
    bb = visual_params["backbone"]

    def conv(p):
        return {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))}

    def bn(p):
        return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                "running_mean": _t(p["mean"]), "running_var": _t(p["var"])}

    sd = {**_prefixed("conv1", conv(bb["conv1"])), **_prefixed("bn1", bn(bb["bn1"]))}
    for name, p in bb.items():
        if not name.startswith("layer"):
            continue
        stage, block = name[len("layer"):].split("_")
        prefix = f"layer{stage}.{block}"
        for i in (1, 2, 3):
            sd.update(_prefixed(f"{prefix}.conv{i}", conv(p[f"conv{i}"])))
            sd.update(_prefixed(f"{prefix}.bn{i}", bn(p[f"bn{i}"])))
        if "ds_conv" in p:
            sd.update(_prefixed(f"{prefix}.downsample.0", conv(p["ds_conv"])))
            sd.update(_prefixed(f"{prefix}.downsample.1", bn(p["ds_bn"])))
    return sd


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def normalize_reference_keys(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The reference's legacy-key renaming pass (inference.py:172-193), a
    copy of `macsa_tpu.train.torch_import.normalize_reference_keys`, so
    reference `.pth` files load into the port with `strict=True`."""
    out = {}
    for key, value in state_dict.items():
        new_key = key
        for prefix in ("module.",):  # DDP wrapper
            if new_key.startswith(prefix):
                new_key = new_key[len(prefix):]
        new_key = new_key.replace("ent2img", "text2img")
        new_key = new_key.replace("ent2roi", "text2roi")
        new_key = new_key.replace("comb_attention", "mm_attention")
        if new_key.startswith("encoder.text_pooler.") or \
                new_key.startswith("encoder.classifier."):
            new_key = new_key.replace("encoder.", "", 1)
        if not new_key.startswith(("encoder.", "decoder.", "text_pooler.",
                                   "classifier.")):
            new_key = "encoder." + new_key
        out[new_key] = _np(value)
    return out
