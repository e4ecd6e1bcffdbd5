"""Tokenizer loading for the port's drivers.

`load_tokenizer(path)` returns what the datasets call: with `transformers`
installed, `AutoTokenizer` wrapped in `ThreadSafeTokenizer`, as
`macsa_tpu/train/common.py:load_tokenizer` does.  Without it,
`WordLevelTokenizer`: a reader of `tokenizer.json` for exactly
one tokenizer model, the one `data/synth.py` and
`tools_dev/make_synth_data.py` write — a WordLevel vocabulary behind a
Whitespace pre-tokenizer and a TemplateProcessing post-processor, with no
normalizer — that reproduces the HF fast tokenizer's output for the call the
datasets make.  Any other model, pre-tokenizer, normalizer or
post-processor in the file raises with its name: it never guesses.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from macsa_tpu_torch.data.loader import ThreadSafeTokenizer

# the `tokenizers` Whitespace pre-tokenizer: runs of word characters, or runs
# of anything that is neither a word character nor a space.  Its `\w` also
# takes combining marks, which Python's does not: they are added by range.
_WORD = "[\\w\u0300-\u036f]"
_WHITESPACE_SPLIT = re.compile(rf"{_WORD}+|(?:(?!{_WORD})\S)+")
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")


def _token_text(entry) -> Optional[str]:
    """A special token of tokenizer_config.json: a string or an AddedToken dict."""
    if isinstance(entry, dict):
        return entry.get("content")
    return entry


class WordLevelTokenizer:
    """The subset of a HF fast tokenizer the datasets and the generation
    harness use: `__call__` on a text, a text pair or a list of texts with
    `max_length`, `truncation` (False, "only_first", or True on single
    texts), `padding` (False or "max_length") and `return_token_type_ids`;
    `decode`; `pad_token_id` and the other special tokens' ids (`None`
    where `tokenizer_config.json` names none); `__len__`."""

    def __init__(self, vocab: Dict[str, int], unk_token: str, single: Sequence[Tuple[str, int]],
                 pair: Sequence[Tuple[str, int]], specials: Sequence[str], pad_token: str,
                 named_specials: Optional[Dict[str, Optional[str]]] = None):
        self.vocab = dict(vocab)
        self._tokens = {i: tok for tok, i in self.vocab.items()}
        for key in _SPECIAL_KEYS:  # bos_token_id, eos_token_id, sep_token_id, cls_token_id, ...
            token = (named_specials or {}).get(key)
            setattr(self, f"{key}_id", self.vocab.get(token) if token is not None else None)
        self.unk_token = unk_token
        if unk_token not in self.vocab:
            raise ValueError(f"unk_token {unk_token!r} is not in the vocabulary")
        self._templates = {1: list(single), 2: list(pair)}
        self.pad_token = pad_token
        self.pad_token_id = self.vocab[pad_token]
        # special tokens are cut out of the raw text before the pre-tokenizer
        # sees it; where two could start at one place the longer wins
        found = sorted({s for s in specials if s}, key=len, reverse=True)
        for s in found:
            if s not in self.vocab:
                raise ValueError(f"special token {s!r} is not in the vocabulary")
        self._special_split = re.compile("(" + "|".join(map(re.escape, found)) + ")") \
            if found else None
        self._specials = set(found)

    @classmethod
    def from_dir(cls, path: str) -> "WordLevelTokenizer":
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        config_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as f:
                config = json.load(f)

        def kind(part):
            return None if part is None else part.get("type")

        model = spec.get("model") or {}
        if kind(model) != "WordLevel":
            raise ValueError(f"tokenizer model {kind(model)!r}: only WordLevel is read")
        if spec.get("normalizer") is not None:
            raise ValueError(f"normalizer {kind(spec['normalizer'])!r}: only none is read")
        if kind(spec.get("pre_tokenizer")) != "Whitespace":
            raise ValueError(f"pre-tokenizer {kind(spec.get('pre_tokenizer'))!r}: only "
                             "Whitespace is read")
        post = spec.get("post_processor")
        if kind(post) != "TemplateProcessing":
            raise ValueError(f"post-processor {kind(post)!r}: only TemplateProcessing is read")
        if spec.get("decoder") is not None:
            raise ValueError(f"decoder {kind(spec['decoder'])!r}: only none is read")

        def template(pieces):
            out = []
            for piece in pieces:
                (what, body), = piece.items()
                if what == "SpecialToken":
                    ids = post["special_tokens"][body["id"]]["tokens"]
                    out.extend((tok, body["type_id"]) for tok in ids)
                elif what == "Sequence":
                    out.append((f"${body['id']}", body["type_id"]))
                else:
                    raise ValueError(f"template piece {what!r} is not read")
            return out

        specials = [t["content"] for t in spec.get("added_tokens") or [] if t.get("special")]
        specials += [_token_text(config.get(k)) for k in _SPECIAL_KEYS]
        specials += [_token_text(t) for t in config.get("additional_special_tokens") or []]
        pad = _token_text(config.get("pad_token"))
        if pad is None:
            raise ValueError("tokenizer_config.json names no pad_token")
        return cls(model["vocab"], model["unk_token"], template(post["single"]),
                   template(post["pair"]), specials, pad,
                   {k: _token_text(config.get(k)) for k in _SPECIAL_KEYS})

    def __len__(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[int]:
        """Token ids of one text, without the template's special tokens."""
        unk = self.vocab[self.unk_token]
        pieces = self._special_split.split(text) if self._special_split else [text]
        ids: List[int] = []
        for piece in pieces:
            if piece in self._specials:
                ids.append(self.vocab[piece])
            else:
                ids.extend(self.vocab.get(word, unk)
                           for word in _WHITESPACE_SPLIT.findall(piece))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """The tokens of `ids` joined by one space (a WordLevel model with no
        decoder), without the special tokens when asked."""
        tokens = [self._tokens[int(i)] for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in self._specials]
        return " ".join(tokens)

    def __call__(self, text, text_pair: Optional[str] = None, max_length: Optional[int] = None,
                 truncation=False, padding=False, return_token_type_ids: bool = True,
                 ) -> Dict[str, list]:
        if isinstance(text, (list, tuple)):  # a batch of single texts: lists of rows
            if text_pair is not None:
                raise ValueError("a batch of text pairs is not offered")
            rows = [self(t, None, max_length, truncation, padding, return_token_type_ids)
                    for t in text]
            return {k: [row[k] for row in rows] for k in rows[0]} if rows else {}
        if truncation is True and text_pair is None:
            truncation = "only_first"  # one sequence: the two strategies are one
        if truncation not in (False, "only_first") or padding not in (False, "max_length"):
            raise ValueError(f"truncation={truncation!r}, padding={padding!r}: not offered")
        seqs = {"$A": self.tokenize(text)}
        if text_pair is not None:
            seqs["$B"] = self.tokenize(text_pair)
        template = self._templates[len(seqs)]
        if truncation and max_length is not None:
            added = sum(1 for tok, _ in template if not tok.startswith("$"))
            over = added + sum(map(len, seqs.values())) - max_length
            if over > 0:
                if over >= len(seqs["$A"]):
                    raise ValueError(f"truncation to {max_length}: the first sequence has "
                                     f"{len(seqs['$A'])} tokens and {over} must go")
                seqs["$A"] = seqs["$A"][:len(seqs["$A"]) - over]
        ids: List[int] = []
        types: List[int] = []
        for tok, type_id in template:
            part = seqs[tok] if tok.startswith("$") else [self.vocab[tok]]
            ids.extend(part)
            types.extend([type_id] * len(part))
        mask = [1] * len(ids)
        if padding == "max_length" and max_length is not None and len(ids) < max_length:
            pad = max_length - len(ids)
            ids += [self.pad_token_id] * pad
            types += [0] * pad
            mask += [0] * pad
        out = {"input_ids": ids, "attention_mask": mask}
        if return_token_type_ids:
            out["token_type_ids"] = types
        return out


def load_tokenizer(pretrained_path: str):
    """The tokenizer under `pretrained_path`, safe for the loader's thread
    pool: HF's where `transformers` imports, else the `tokenizer.json` reader."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return WordLevelTokenizer.from_dir(pretrained_path)
    return ThreadSafeTokenizer(
        AutoTokenizer.from_pretrained(pretrained_path, local_files_only=True))
