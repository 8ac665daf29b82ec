"""Prompt tokenizer (the port's own copy of the JAX package's
``utils/tokenizer.py`` word tokenizer).

The repository holds no CLIP vocabulary files, so, as in the JAX package,
pipelines use ``SimpleWordTokenizer``: a deterministic word-level tokenizer
with the protocol the P2P helpers rely on (``encode`` with BOS/EOS,
single-token ``decode``, ``model_max_length``). Its vocabulary grows lazily in
call order, so two instances fed the same texts in the same order give the
same ids. The CLIP BPE tokenizer comes with real checkpoints (ROADMAP A11).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence


class SimpleWordTokenizer:
    """Word-level tokenizer with a lazily-grown vocabulary.

    ids: 0 = BOS, 1 = EOS, 2 = PAD, words start at 3. ``encode`` mirrors the
    CLIP contract used by seq_aligner / get_word_inds: [bos, *words, eos].
    """

    bos_token_id = 0
    eos_token_id = 1
    pad_token_id = 2

    def __init__(self, model_max_length: int = 77):
        self.model_max_length = model_max_length
        self._vocab: Dict[str, int] = {}
        self._inv: Dict[int, str] = {0: "<|startoftext|>", 1: "<|endoftext|>", 2: ""}

    def _word_id(self, word: str) -> int:
        if word not in self._vocab:
            idx = 3 + len(self._vocab)
            self._vocab[word] = idx
            self._inv[idx] = word
        return self._vocab[word]

    @staticmethod
    def _normalize(text: str) -> List[str]:
        text = text.lower().strip()
        return [w for w in re.split(r"\s+", text) if w]

    def encode(self, text: str) -> List[int]:
        words = self._normalize(text)
        return [self.bos_token_id] + [self._word_id(w) for w in words] + [self.eos_token_id]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self._inv.get(int(i), "") for i in ids)

    def __call__(self, texts, padding: str = "max_length", max_length: Optional[int] = None,
                 truncation: bool = True):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for t in texts:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            if padding == "max_length":
                # CLIP pads with EOS (pad_token == eos in SD1.4's tokenizer config)
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}


def default_tokenizer() -> SimpleWordTokenizer:
    """A fresh word tokenizer: each pipeline threads its own instance, so word
    ids never depend on which caller encoded first."""
    return SimpleWordTokenizer()
