"""Minimal deterministic character tokenizer for the synthetic math task.

Vocabulary: specials + digits + operators + letters.  Stable ids so that
checkpoints remain valid across runs.
"""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 0, 1, 2
_CHARS = "0123456789+-*/=() .,?abcdefghijklmnopqrstuvwxyz<>|#"
_STOI = {c: i + 3 for i, c in enumerate(_CHARS)}
_ITOS = {i + 3: c for i, c in enumerate(_CHARS)}

VOCAB_SIZE = len(_CHARS) + 3


def encode(text: str, bos: bool = False, eos: bool = False) -> List[int]:
    ids = [_STOI[c] for c in text.lower() if c in _STOI]
    if bos:
        ids = [BOS] + ids
    if eos:
        ids = ids + [EOS]
    return ids


def decode(ids) -> str:
    return "".join(_ITOS.get(int(i), "") for i in ids if int(i) > 2)
