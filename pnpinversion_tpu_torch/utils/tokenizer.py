"""Prompt tokenizer (the port's own copy of the JAX package's
``utils/tokenizer.py`` word tokenizer).

- ``CLIPBPETokenizer``: CLIP's byte-level BPE on local vocabulary files, HF
  ``vocab.json`` + ``merges.txt`` or OpenAI's ``bpe_simple_vocab_16e6.txt``
  (``.gz``), as a checkpoint's ``tokenizer/`` directory holds them;
- ``SimpleWordTokenizer``: a deterministic word-level tokenizer with the
  protocol the P2P helpers rely on (``encode`` with BOS/EOS, single-token
  ``decode``, ``model_max_length``), for pipelines without vocabulary files.
  Its vocabulary grows lazily in call order, so two instances fed the same
  texts in the same order give the same ids;
- ``BertWordPieceTokenizer``: BLIP's text tokenizer, on a local
  ``vocab.txt``.

``default_tokenizer(vocab_dir)`` picks the BPE tokenizer when the directory
has its files (one instance per directory, cached), else a fresh word
tokenizer, as the JAX package's does.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
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


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


_WHITESPACE_RE = re.compile(r"\s+")
# the JAX package's pattern (Python's ``re`` has no \p classes): ASCII
# letters and digits, and any other run of non-space characters as one token
_CLIP_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)
_OPENAI_BPE = ("bpe_simple_vocab_16e6.txt.gz", "bpe_simple_vocab_16e6.txt")


class CLIPBPETokenizer:
    """CLIP's byte-level BPE tokenizer on local files: HF ``vocab.json`` +
    ``merges.txt``, or OpenAI's ``bpe_simple_vocab_16e6.txt[.gz]`` (its
    first 48,894 merges, the vocabulary built from the bytes and them)."""

    def __init__(self, vocab_dir: str, model_max_length: int = 77):
        self.model_max_length = model_max_length
        vocab_json = os.path.join(vocab_dir, "vocab.json")
        merges_txt = os.path.join(vocab_dir, "merges.txt")
        openai_bpe = next((os.path.join(vocab_dir, n) for n in _OPENAI_BPE
                           if os.path.exists(os.path.join(vocab_dir, n))), None)
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if os.path.exists(vocab_json) and os.path.exists(merges_txt):
            with open(vocab_json) as f:
                self.encoder: Dict[str, int] = json.load(f)
            with open(merges_txt) as f:
                lines = f.read().split("\n")
            if lines and lines[0].startswith("#"):
                lines = lines[1:]
            merges = [tuple(line.split()) for line in lines if line and len(line.split()) == 2]
        elif openai_bpe is not None:
            opener = gzip.open if openai_bpe.endswith(".gz") else open
            with opener(openai_bpe, "rt") as f:
                merge_lines = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merge_lines]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            raise FileNotFoundError(f"no CLIP vocab files found in {vocab_dir!r} "
                                    "(need vocab.json+merges.txt or bpe_simple_vocab_16e6.txt[.gz])")
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = self.eos_token_id

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    @staticmethod
    def _clean(text: str) -> str:
        text = html.unescape(html.unescape(text))
        return _WHITESPACE_RE.sub(" ", text).strip().lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = [self.bos_token_id]
        for token in _CLIP_PAT.findall(self._clean(text)):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_b).split(" "))
        ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

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
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
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


@functools.lru_cache(maxsize=4)
def _cached_bpe(vocab_dir: str) -> CLIPBPETokenizer:
    return CLIPBPETokenizer(vocab_dir)


def default_tokenizer(vocab_dir: Optional[str] = None):
    """The CLIP BPE tokenizer of ``vocab_dir`` when it holds the vocabulary
    files (one cached instance per directory: it is stateless), else a fresh
    word tokenizer: its vocabulary grows with the texts it sees, so each
    pipeline threads its own instance and word ids never depend on which
    caller encoded first."""
    if vocab_dir is not None:
        try:
            return _cached_bpe(vocab_dir)
        except FileNotFoundError:
            pass
    return SimpleWordTokenizer()
