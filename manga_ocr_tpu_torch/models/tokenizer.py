"""Character-level Japanese tokenizer + output post-processing (the port's
own copy of ``manga_ocr_tpu/models/tokenizer.py``).

The manga-ocr model decodes to text with a BERT-style character-level
vocabulary and then normalizes the string (whitespace stripping, ellipsis
normalization, halfwidth→fullwidth conversion).  This module implements
that behavior with no external deps:

- ``CharTokenizer`` loads a BERT ``vocab.txt`` (one token per line; ids are
  line numbers) and provides encode/decode with the standard special tokens
  ([PAD]=0, [UNK]=1, [CLS]=2, [SEP]=3, [MASK]=4 by convention of the vocab
  file itself — ids are read from the file, never hardcoded).
- ``post_process`` mirrors the published manga-ocr text cleanup: drop all
  whitespace, normalize ellipsis runs to ASCII dots, convert halfwidth
  katakana/ASCII/digits to fullwidth.

``CharTokenizer.synthetic`` makes a deterministic vocab for tests and for
running the full-size model without the real checkpoint.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Halfwidth -> fullwidth conversion (jaconv.h2z equivalent subset)
# ---------------------------------------------------------------------------

# Halfwidth katakana (U+FF61..U+FF9F) -> fullwidth equivalents.
_HW_KATAKANA = {
    "｡": "。", "｢": "「", "｣": "」", "､": "、", "･": "・",
    "ｦ": "ヲ", "ｧ": "ァ", "ｨ": "ィ", "ｩ": "ゥ", "ｪ": "ェ", "ｫ": "ォ",
    "ｬ": "ャ", "ｭ": "ュ", "ｮ": "ョ", "ｯ": "ッ", "ｰ": "ー",
    "ｱ": "ア", "ｲ": "イ", "ｳ": "ウ", "ｴ": "エ", "ｵ": "オ",
    "ｶ": "カ", "ｷ": "キ", "ｸ": "ク", "ｹ": "ケ", "ｺ": "コ",
    "ｻ": "サ", "ｼ": "シ", "ｽ": "ス", "ｾ": "セ", "ｿ": "ソ",
    "ﾀ": "タ", "ﾁ": "チ", "ﾂ": "ツ", "ﾃ": "テ", "ﾄ": "ト",
    "ﾅ": "ナ", "ﾆ": "ニ", "ﾇ": "ヌ", "ﾈ": "ネ", "ﾉ": "ノ",
    "ﾊ": "ハ", "ﾋ": "ヒ", "ﾌ": "フ", "ﾍ": "ヘ", "ﾎ": "ホ",
    "ﾏ": "マ", "ﾐ": "ミ", "ﾑ": "ム", "ﾒ": "メ", "ﾓ": "モ",
    "ﾔ": "ヤ", "ﾕ": "ユ", "ﾖ": "ヨ",
    "ﾗ": "ラ", "ﾘ": "リ", "ﾙ": "ル", "ﾚ": "レ", "ﾛ": "ロ",
    "ﾜ": "ワ", "ﾝ": "ン", "ﾞ": "゛", "ﾟ": "゜",
}

# Base kana that combine with the voiced (゛) / semi-voiced (゜) marks.
_VOICED = {
    "カ": "ガ", "キ": "ギ", "ク": "グ", "ケ": "ゲ", "コ": "ゴ",
    "サ": "ザ", "シ": "ジ", "ス": "ズ", "セ": "ゼ", "ソ": "ゾ",
    "タ": "ダ", "チ": "ヂ", "ツ": "ヅ", "テ": "デ", "ト": "ド",
    "ハ": "バ", "ヒ": "ビ", "フ": "ブ", "ヘ": "ベ", "ホ": "ボ",
    "ウ": "ヴ",
}
_SEMI_VOICED = {"ハ": "パ", "ヒ": "ピ", "フ": "プ", "ヘ": "ペ", "ホ": "ポ"}


def h2z(text: str, ascii_: bool = True, digit: bool = True, kana: bool = True) -> str:
    """Halfwidth -> fullwidth conversion for kana, ASCII and digits."""
    out: list[str] = []
    for ch in text:
        code = ord(ch)
        if kana and ch in _HW_KATAKANA:
            conv = _HW_KATAKANA[ch]
            if conv == "゛" and out and out[-1] in _VOICED:
                out[-1] = _VOICED[out[-1]]
                continue
            if conv == "゜" and out and out[-1] in _SEMI_VOICED:
                out[-1] = _SEMI_VOICED[out[-1]]
                continue
            out.append(conv)
        elif digit and "0" <= ch <= "9":
            out.append(chr(code - 0x30 + 0xFF10))
        elif ascii_ and 0x21 <= code <= 0x7E and not ("0" <= ch <= "9"):
            out.append(chr(code - 0x21 + 0xFF01))
        elif ascii_ and ch == " ":
            out.append("　")
        else:
            out.append(ch)
    return "".join(out)


def post_process(text: str) -> str:
    """Normalize decoded OCR text the way the reference engine's output is
    normalized before reaching ``perform_ocr``'s caller."""
    text = "".join(text.split())
    text = text.replace("…", "...")
    text = re.sub(r"[・.]{2,}", lambda m: "." * (m.end() - m.start()), text)
    return h2z(text)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


class CharTokenizer:
    """BERT-vocab character tokenizer (decode-oriented; encode for tests)."""

    def __init__(self, vocab: Sequence[str]):
        self.id_to_token = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(self.id_to_token)}
        self.pad_id = self.token_to_id.get("[PAD]", 0)
        self.unk_id = self.token_to_id.get("[UNK]", 1)
        self.cls_id = self.token_to_id.get("[CLS]", 2)
        self.sep_id = self.token_to_id.get("[SEP]", 3)
        self._special_ids = {
            self.token_to_id[t] for t in SPECIAL_TOKENS if t in self.token_to_id
        }

    def __len__(self) -> int:
        return len(self.id_to_token)

    @staticmethod
    def from_vocab_file(path: str) -> "CharTokenizer":
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f]
        return CharTokenizer(vocab)

    @staticmethod
    def synthetic(extra_chars: Iterable[str] = ()) -> "CharTokenizer":
        """Deterministic vocab covering hiragana, katakana, ASCII fullwidth,
        digits, common punctuation and any extra chars — for tests and
        checkpoint-free runs."""
        chars: list[str] = []
        chars += [chr(c) for c in range(0x3041, 0x3097)]  # hiragana
        chars += [chr(c) for c in range(0x30A1, 0x30FB)]  # katakana
        chars += ["ー", "。", "、", "「", "」", "・", "!", "?", "…", "."]
        chars += [chr(c) for c in range(0xFF01, 0xFF5F)]  # fullwidth ASCII
        chars += [chr(c) for c in range(0x0020, 0x007F)]  # ASCII
        chars += list(extra_chars)
        seen, ordered = set(), []
        for ch in chars:
            if ch not in seen:
                seen.add(ch)
                ordered.append(ch)
        return CharTokenizer(list(SPECIAL_TOKENS) + ordered)

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        """Char ids with the upstream tokenizer's input conventions: NFKC
        normalization first (fullwidth ASCII folds to halfwidth, ellipsis
        decomposes to dots), whitespace never becomes a token — verified
        against transformers' char-level BertJapaneseTokenizer in
        tests/test_tokenizer_crosscheck.py.  decode()+post_process then
        restores fullwidth forms, matching the upstream round trip."""
        import unicodedata

        text = unicodedata.normalize("NFKC", text)
        ids = [
            self.token_to_id.get(ch, self.unk_id)
            for ch in text
            if not ch.isspace()
        ]
        if add_special:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids

    def decode_ids(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special and i in self._special_ids:
                continue
            if 0 <= i < len(self.id_to_token):
                toks.append(self.id_to_token[i])
        return "".join(toks)

    def decode(self, ids: Iterable[int]) -> str:
        """Decode + manga-ocr post-processing (the text the engine returns)."""
        return post_process(self.decode_ids(ids))

    def decode_batch(self, tokens: np.ndarray, lengths: np.ndarray | None = None) -> list[str]:
        """Decode a [B, T] batch from ``greedy_decode`` output."""
        out = []
        tokens = np.asarray(tokens)
        for b in range(tokens.shape[0]):
            row = tokens[b]
            if lengths is not None:
                row = row[: int(lengths[b])]
            out.append(self.decode(row))
        return out
