"""Vietnamese text normalization.

Behavioral equivalent of the reference preprocessing
(reference: text_preprocess.py):

* `convert_unicode` — maps legacy decomposed Vietnamese characters to NFC
  composed form (the reference enumerates the character pairs explicitly,
  text_preprocess.py:3-14; Unicode NFC normalization is the same mapping),
* `TextNormalize.normalize` — lowercase, collapse character runs, strip
  emoji / stray punctuation / mentions / hashtags (text_preprocess.py:133-156),
* `TextNormalize.word_standardize` — Vietnamese tone-mark repositioning
  (text_preprocess.py:57-131).  Note: in the reference this is dormant during
  `normalize` because `createVowelsTable` is never invoked
  (text_preprocess.py:35-39); here the table is always built and
  `word_standardize` is usable, but `normalize` matches the reference by NOT
  applying it.
"""

from __future__ import annotations

import re
import unicodedata

_EMOJI_RE = re.compile(
    "["
    "\U0001F600-\U0001F64F"  # emoticons
    "\U0001F300-\U0001F5FF"  # symbols & pictographs
    "\U0001F680-\U0001F6FF"  # transport & map symbols
    "\U0001F1E0-\U0001F1FF"  # flags
    "]+",
    flags=re.UNICODE,
)
_PUNCT_RE = re.compile(r"[:)^@!`~%;?(\+\-\'\"]+")
_TAG_RE = re.compile(r"(@[A-Za-z0-9]+)|(#[0-9A-Za-z]+)")
_CHAR_RUN_RE = re.compile(r"(\w)\1+", flags=re.UNICODE)
_SPACE_RUN_RE = re.compile(r"( )\1+")


def convert_unicode(text: str) -> str:
    """Legacy decomposed Vietnamese -> NFC composed form."""
    return unicodedata.normalize("NFC", text)


# Vietnamese vowel table: row = base vowel family, columns = tone variants
# (no tone, grave, acute, hook, tilde, dot); last entry is the telex key.
_VOWELS_TABLE = [
    ["a", "à", "á", "ả", "ã", "ạ", "a"],
    ["ă", "ằ", "ắ", "ẳ", "ẵ", "ặ", "aw"],
    ["â", "ầ", "ấ", "ẩ", "ẫ", "ậ", "aa"],
    ["e", "è", "é", "ẻ", "ẽ", "ẹ", "e"],
    ["ê", "ề", "ế", "ể", "ễ", "ệ", "ee"],
    ["i", "ì", "í", "ỉ", "ĩ", "ị", "i"],
    ["o", "ò", "ó", "ỏ", "õ", "ọ", "o"],
    ["ô", "ồ", "ố", "ổ", "ỗ", "ộ", "o"],
    ["ơ", "ờ", "ớ", "ở", "ỡ", "ợ", "ow"],
    ["u", "ù", "ú", "ủ", "ũ", "ụ", "u"],
    ["ư", "ừ", "ứ", "ử", "ữ", "ự", "uw"],
    ["y", "ỳ", "ý", "ỷ", "ỹ", "ỵ", "y"],
]


class TextNormalize:
    def __init__(self):
        # vowel char -> (table row, tone column)
        self.vowels_to_ids = {
            ch: (row, col)
            for row, variants in enumerate(_VOWELS_TABLE)
            for col, ch in enumerate(variants[:-1])
        }

    # -- tone-mark repositioning ------------------------------------------

    def is_valid_vietnamese_word(self, word: str) -> bool:
        """All vowels in a Vietnamese syllable must be contiguous."""
        last_vowel = -1
        for i, ch in enumerate(word):
            if self.vowels_to_ids.get(ch, (-1, -1))[0] == -1:
                continue
            if last_vowel != -1 and i - last_vowel != 1:
                return False
            last_vowel = i
        return True

    def word_standardize(self, word: str) -> str:
        """Move the tone mark onto the canonical vowel of the syllable."""
        if not self.is_valid_vietnamese_word(word):
            return word

        chars = list(word)
        vowel_indexes = []
        qu_or_gi = False
        tone = 0
        for i, ch in enumerate(chars):
            row, col = self.vowels_to_ids.get(ch, (-1, -1))
            if row == -1:
                continue
            if row == 9 and i != 0 and chars[i - 1] == "q":  # 'qu'
                chars[i] = "u"
                qu_or_gi = True
            elif row == 5 and i != 0 and chars[i - 1] == "g":  # 'gi'
                chars[i] = "i"
                qu_or_gi = True
            if col != 0:  # strip the tone, remember it
                tone = col
                chars[i] = _VOWELS_TABLE[row][0]
            vowel_indexes.append(i)

        def put(idx: int):
            row = self.vowels_to_ids[chars[idx]][0]
            chars[idx] = _VOWELS_TABLE[row][tone]

        if len(vowel_indexes) == 1:
            put(vowel_indexes[0])
            return "".join(chars)

        for idx in vowel_indexes:
            row = self.vowels_to_ids.get(chars[idx], (-1, -1))[0]
            if row in (4, 7, 8):  # ê, ô, ơ take the tone when present
                put(idx)
                return "".join(chars)
            if qu_or_gi:
                if len(vowel_indexes) in (2, 3):
                    put(vowel_indexes[1])
                return "".join(chars)
            if len(vowel_indexes) == 2:
                # final-vowel syllables tone the first vowel, else the last
                put(vowel_indexes[0] if vowel_indexes[-1] == len(chars) - 1
                    else vowel_indexes[-1])
                return "".join(chars)
            if len(vowel_indexes) == 3:
                put(vowel_indexes[1] if vowel_indexes[-1] == len(chars) - 1
                    else vowel_indexes[-1])
                return "".join(chars)
        return "".join(chars)

    # -- sentence-level cleanup --------------------------------------------

    def normalize(self, text: str) -> str:
        text = text.lower()
        text = _CHAR_RUN_RE.sub(r"\1", text)     # rút gọn từ kéo dài
        text = _EMOJI_RE.sub("", text)
        text = _SPACE_RUN_RE.sub(r"\1", text)
        text = _PUNCT_RE.sub("", text)
        text = text.replace("“", "")        # left double quote
        text = _TAG_RE.sub("", text)
        return text
