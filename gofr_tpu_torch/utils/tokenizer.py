"""Dependency-free byte tokenizer for string-in / text-out serving (the
port's own copy of gofr_tpu/utils/tokenizer.py).

The engine accepts any object with ``encode(str) -> list[int]`` and
``decode(list[int]) -> str``; this one maps UTF-8 bytes past three special
ids, so it works with any model whose vocabulary has at least 259 entries.
"""

from __future__ import annotations

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
_OFFSET = 3


class ByteTokenizer:
    """Reversible UTF-8 byte tokenizer: id = byte + 3 (0/1/2 = pad/bos/eos)."""

    vocab_size = 256 + _OFFSET
    pad_token_id = PAD_ID
    bos_token_id = BOS_ID
    eos_token_id = EOS_ID

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [b + _OFFSET for b in text.encode("utf-8")]
        return [BOS_ID] + ids if add_bos else ids

    def decode(self, ids) -> str:
        # specials and ids past the byte range are skipped, never a crash;
        # a split multi-byte character decodes as U+FFFD
        data = bytes(int(i) - _OFFSET for i in ids if _OFFSET <= int(i) < 256 + _OFFSET)
        return data.decode("utf-8", errors="replace")
