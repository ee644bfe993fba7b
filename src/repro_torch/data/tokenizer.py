"""Minimal byte-level tokenizer (vocab 256 + specials) for runnable
text examples without external assets."""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 256, 257, 258
VOCAB = 259


class ByteTokenizer:
    vocab_size = VOCAB
    pad_id, bos_id, eos_id = PAD, BOS, EOS

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        b = bytes(i for i in ids if 0 <= i < 256)
        return b.decode("utf-8", errors="replace")
