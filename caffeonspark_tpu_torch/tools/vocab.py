"""Vocab: word-frequency vocabulary for caption models.

The port's copy of `caffeonspark_tpu/tools/vocab.py` (Caffe's
`caffe-grid/.../tools/Vocab.scala:12-64`): build from captions by
descending frequency, save/load as one word per line; reserved ids —
0 = sentence start/end marker, 1 = UNK; real words start at id 2 (the
vocab_size most frequent words).  Files are byte-equal to the JAX
package's for the same captions."""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Dict, Iterable, List

START_END_ID = 0
UNK_ID = 1
FIRST_WORD_ID = 2

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(caption: str) -> List[str]:
    return _TOKEN_RE.findall(caption.lower())


class Vocab:
    def __init__(self, words: List[str]):
        self.words = list(words)
        self.index: Dict[str, int] = {
            w: i + FIRST_WORD_ID for i, w in enumerate(self.words)}

    @classmethod
    def build(cls, captions: Iterable[str], vocab_size: int) -> "Vocab":
        counts = Counter()
        for c in captions:
            counts.update(tokenize(c))
        most = [w for w, _ in counts.most_common(max(0, vocab_size
                                                     - FIRST_WORD_ID))]
        return cls(most)

    # -- io ----------------------------------------------------------------
    @staticmethod
    def resolve_path(path: str) -> str:
        """The vocab FILE for a save/load path: directories (existing or
        intended — no file extension) hold `vocab.txt`; anything with an
        extension is the file itself.  One rule shared by save/load/
        exists so callers can't drift apart."""
        if os.path.isdir(path) or not os.path.splitext(path)[1]:
            return os.path.join(path, "vocab.txt")
        return path

    @classmethod
    def exists(cls, path: str) -> bool:
        return os.path.exists(cls.resolve_path(path))

    def save(self, path: str) -> None:
        path = self.resolve_path(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for w in self.words:
                f.write(w + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(cls.resolve_path(path)) as f:
            return cls([l.rstrip("\n") for l in f if l.strip()])

    # -- mapping -----------------------------------------------------------
    def word_to_id(self, w: str) -> int:
        return self.index.get(w, UNK_ID)

    def id_to_word(self, i: int) -> str:
        if i == START_END_ID:
            return "<EOS>"
        if i == UNK_ID:
            return "<unk>"
        j = i - FIRST_WORD_ID
        return self.words[j] if 0 <= j < len(self.words) else "<unk>"

    def encode(self, caption: str) -> List[int]:
        return [self.word_to_id(w) for w in tokenize(caption)]

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in ids:
            if i == START_END_ID:
                break
            out.append(self.id_to_word(int(i)))
        return " ".join(out)

    def __len__(self):
        return len(self.words) + FIRST_WORD_ID
