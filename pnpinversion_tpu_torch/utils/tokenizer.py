"""Prompt tokenizer (the port's own copy of the JAX package's
``utils/tokenizer.py`` word tokenizer).

The repository holds no CLIP vocabulary files, so, as in the JAX package,
pipelines use ``SimpleWordTokenizer``: a deterministic word-level tokenizer
with the protocol the P2P helpers rely on (``encode`` with BOS/EOS,
single-token ``decode``, ``model_max_length``). Its vocabulary grows lazily in
call order, so two instances fed the same texts in the same order give the
same ids. The CLIP BPE tokenizer comes with real checkpoints (ROADMAP A13).
``BertWordPieceTokenizer`` is BLIP's text tokenizer (a copy of the JAX
package's), on a local ``vocab.txt``.
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


class BertWordPieceTokenizer:
    """BERT-uncased WordPiece tokenizer (BLIP's text tokenizer) on a local
    ``vocab.txt``: lower-cased words split at punctuation, each word by the
    greedy longest-match-first subword rule ("##" continuations), an unknown
    word as one [UNK]."""

    def __init__(self, vocab_file: str, model_max_length: int = 512):
        self.model_max_length = model_max_length
        with open(vocab_file) as f:
            words = [line.rstrip("\n") for line in f]
        self.vocab = {w: i for i, w in enumerate(words)}
        self.inv = {i: w for w, i in self.vocab.items()}
        self.cls_token_id = self.vocab.get("[CLS]", 101)
        self.sep_token_id = self.vocab.get("[SEP]", 102)
        self.unk_token_id = self.vocab.get("[UNK]", 100)
        self.pad_token_id = self.vocab.get("[PAD]", 0)
        # the shared tokenizer protocol's names
        self.bos_token_id = self.cls_token_id
        self.eos_token_id = self.sep_token_id

    def _wordpiece(self, word: str) -> List[int]:
        out: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_token_id]
            out.append(cur)
            start = end
        return out

    @staticmethod
    def _basic_tokens(text: str) -> List[str]:
        out: List[str] = []
        for tok in text.lower().strip().split():
            cur = ""
            for ch in tok:
                if ch.isalnum():
                    cur += ch
                else:
                    if cur:
                        out.append(cur)
                        cur = ""
                    if not ch.isspace():
                        out.append(ch)
            if cur:
                out.append(cur)
        return out

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_token_id]
        for w in self._basic_tokens(text):
            ids.extend(self._wordpiece(w))
        ids.append(self.sep_token_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv.get(int(i), "") for i in ids
                if int(i) not in (self.cls_token_id, self.sep_token_id, self.pad_token_id)]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    def __call__(self, texts, padding="max_length", max_length=None, truncation=True):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        out = []
        for t in texts:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.sep_token_id]
            if padding == "max_length":
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        return {"input_ids": out}


def default_tokenizer() -> SimpleWordTokenizer:
    """A fresh word tokenizer: each pipeline threads its own instance, so word
    ids never depend on which caller encoded first."""
    return SimpleWordTokenizer()
