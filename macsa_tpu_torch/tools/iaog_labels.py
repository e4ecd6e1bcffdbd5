"""IAOG label generation: train/dev/test.json -> *_with_iaog.json.

Behavioral equivalent of the reference's offline notebook pipeline
(reference: create_IAOG_labels.ipynb cells 4-11, summarized in SURVEY.md §3.5):

1. implicit aspects per review = (aspects labeled from text+images)
   minus (aspects labeled from text alone),
2. candidate opinion words = adjectives found in the comment (underthesea
   pos_tag when installed, else a user-provided adjective lexicon) that also
   carry polarity in a VnEmoLex-style lexicon,
3. an optional LLM filter assigns candidate words to implicit aspects (the
   reference calls Gemini; here any `filter_fn(aspect, words, text) -> words`
   callable can be plugged; the default keeps all candidates),
4. emits `iaog_labels = ["word#Aspect", ...]` into <split>_with_iaog.json —
   the exact format IAOGDataset consumes (iaog_dataset.py:32-58).

A copy of `macsa_tpu/tools/iaog_labels.py` for the PyTorch port (host code
only; it imports neither torch nor a device).

Run: python -m macsa_tpu_torch.tools.iaog_labels --data_dir data/ \
       --emolex vnemolex.csv [--adjective_lexicon adjs.txt]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable, Dict, List, Optional, Set

from macsa_tpu_torch.config import ASPECTS


def load_polarity_lexicon(path: str) -> Set[str]:
    """VnEmoLex-style CSV: first column = word; keep rows with any nonzero
    polarity flag (or all words when no flag columns exist)."""
    words: Set[str] = set()
    with open(path, encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        for row in reader:
            if not row:
                continue
            word = row[0].strip().lower()
            flags = row[1:]
            if not flags or any(v.strip() not in ("", "0") for v in flags):
                words.add(word)
    return words


def extract_adjectives(text: str, adjective_lexicon: Optional[Set[str]] = None
                       ) -> List[str]:
    """Adjectives via underthesea pos_tag when available, else lexicon lookup."""
    try:
        from underthesea import pos_tag
        return [w.lower() for w, tag in pos_tag(text) if tag == "A"]
    except ImportError:
        if adjective_lexicon is None:
            return []
        toks = text.lower().split()
        out = [t for t in toks if t in adjective_lexicon]
        # also try bigrams (Vietnamese compound adjectives)
        out += [f"{a} {b}" for a, b in zip(toks, toks[1:])
                if f"{a} {b}" in adjective_lexicon]
        return out


def implicit_aspects(text_img_label: List[str],
                     text_label: List[str]) -> List[str]:
    """aspects in (text+image) labels but NOT in text-only labels (cell 9)."""
    full = {lbl.split("#")[0] for lbl in (text_img_label or [])}
    text_only = {lbl.split("#")[0] for lbl in (text_label or [])}
    return [a for a in ASPECTS if a in (full - text_only)]


def generate_iaog_labels(
    records: List[Dict],
    polarity_lexicon: Set[str],
    adjective_lexicon: Optional[Set[str]] = None,
    filter_fn: Optional[Callable[[str, List[str], str], List[str]]] = None,
) -> List[Dict]:
    """Adds `iaog_labels` to each record (in place; also returned)."""
    for rec in records:
        text = rec.get("comment", "")
        aspects = implicit_aspects(rec.get("text_img_label"),
                                   rec.get("text_label"))
        candidates = [w for w in dict.fromkeys(
            extract_adjectives(text, adjective_lexicon))
            if w in polarity_lexicon]
        labels: List[str] = []
        for asp in aspects:
            words = (filter_fn(asp, candidates, text) if filter_fn
                     else candidates)
            labels.extend(f"{w}#{asp}" for w in words)
        rec["iaog_labels"] = labels
    return records


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--emolex", type=str, required=True,
                   help="VnEmoLex-style polarity lexicon CSV")
    p.add_argument("--adjective_lexicon", type=str, default=None,
                   help="newline-separated adjectives (fallback when "
                        "underthesea is not installed)")
    p.add_argument("--splits", type=str, nargs="*",
                   default=["train", "dev", "test"])
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    out_dir = args.output_dir or args.data_dir
    lexicon = load_polarity_lexicon(args.emolex)
    adj = None
    if args.adjective_lexicon:
        with open(args.adjective_lexicon, encoding="utf-8") as f:
            adj = {line.strip().lower() for line in f if line.strip()}
    for split in args.splits:
        path = os.path.join(args.data_dir, f"{split}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            records = json.load(f)
        if isinstance(records, dict):  # pandas orient
            from macsa_tpu_torch.train.common import load_records
            records = load_records(path, normalize=False)
        generate_iaog_labels(records, lexicon, adj)
        out = os.path.join(out_dir, f"{split}_with_iaog.json")
        with open(out, "w") as f:
            json.dump(records, f, ensure_ascii=False)
        nonempty = sum(1 for r in records if r["iaog_labels"])
        print(f"{out}: {nonempty}/{len(records)} records with iaog_labels")


if __name__ == "__main__":
    main()
